"""The decode program's analytic cost record and the roofline it feeds.

``serving/model.py:decode_cost`` counts one decode tick: its products
(FLOPs) and the least bytes it must move, term by term. The products are
held to ``torch.utils.flop_counter.FlopCounterMode``'s count of the tick
itself, the weight term to the model's parameter bytes, the FLOPs to the
JAX package's XLA cost analysis of the same program (which also counts
the elementwise work: layer norms, softmax, gelu, masking), and the
roofline document to the JAX package's. Also: the cold-start shed seeded
from the roofline, and ``calibrate``'s repaired dispatch leg (host wall
time) and copy-probe sizing.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from paddle_tpu import serving as jserving
from paddle_tpu_torch import errors
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import ledger as serving_ledger
from paddle_tpu_torch.serving import model as smodel

# the tiny serving config of tests/test_serving.py, and one whose context
# is not a whole number of blocks (the gather window rounds up)
_CFGS = {
    "tiny": (dict(vocab_size=128, n_layer=2, n_head=2, d_model=32,
                  max_seq_len=64),
             dict(max_batch=4, n_blocks=16, block_size=8,
                  prefill_buckets=[16, 32])),
    "ragged": (dict(vocab_size=96, n_layer=3, n_head=4, d_model=64,
                    max_seq_len=60),
               dict(max_batch=3, n_blocks=24, block_size=16,
                    prefill_buckets=[16, 32])),
}
# analytic products over XLA's count at the tiny config: XLA also counts
# the elementwise work, so the ratio lies below 1; at this width the
# elementwise share is largest (0.77 measured here)
_XLA_RATIO = (0.6, 1.0)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    serving_ledger.reset()
    yield
    serving_ledger.reset()


def _model(name, **kw):
    cfg, env = _CFGS[name]
    return serving.DecodeModel(serving.GPTConfig(**cfg), device="cpu",
                               seed=1, **{**env, **kw})


def _tick_flops(m):
    """FlopCounterMode's count of one decode tick with live slots."""
    B, S = m.max_batch, m.gather_len
    tables = np.zeros((B, m.max_blocks_per_req), np.int64)
    for b in range(B):
        tables[b] = 1 + (b + np.arange(m.max_blocks_per_req)) % (
            m.n_blocks - 1)
    pos = (np.arange(B) * 7) % S
    with FlopCounterMode(display=False) as fc:
        m.decode(m.init_pages(), tables, pos, np.arange(B) % 5)
    return fc.get_total_flops()


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_analytic_flops_equal_flop_counter(name):
    m = _model(name)
    cost = m.insights["decode"]
    assert cost.flops == _tick_flops(m)
    t = cost.terms
    assert cost.flops == (t["flops_proj"] + t["flops_mlp"]
                          + t["flops_attn"] + t["flops_lm_head"])


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_weight_term_is_the_parameter_bytes(name):
    """Every parameter is read whole but wpe, of which a tick reads the B
    rows at its slots' positions."""
    m = _model(name)
    t = m.insights["decode"].terms
    wpe = m.params["gpt.wpe"]
    assert t["bytes_weights"] + wpe.nbytes == sum(
        p.nbytes for p in m.params.values())
    assert t["bytes_wpe_rows"] == m.max_batch * wpe[0].nbytes


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_byte_terms_match_the_tensors_of_a_tick(name):
    """The K/V terms are the gathered and scattered tensors' own sizes,
    and the program as written adds the gather's copy and re-read and
    the logits."""
    m = _model(name)
    cost = m.insights["decode"]
    t = cost.terms
    L, B = m.cfg.n_layer, m.max_batch
    pages = m.init_pages()
    gathered = pages[0, 0][torch.zeros((B, m.max_blocks_per_req),
                                       dtype=torch.int64)]
    assert t["bytes_kv_read"] == 2 * L * gathered.nbytes
    assert t["bytes_kv_write"] == 2 * L * pages[0, 0, 0, 0].nbytes * B
    assert t["bytes_io"] == 8 * (B * m.max_blocks_per_req + 3 * B)
    assert cost.bytes_accessed == sum(t[k] for k in (
        "bytes_weights", "bytes_wpe_rows", "bytes_kv_read",
        "bytes_kv_write", "bytes_io"))
    assert t["bytes_kv_gather_copy"] == 2 * t["bytes_kv_read"]
    assert t["bytes_logits"] == 2 * B * m.params["gpt.wte"][:, 0].nbytes
    assert cost.bytes_as_written == (cost.bytes_accessed
                                     + t["bytes_kv_gather_copy"]
                                     + t["bytes_logits"])


def test_cost_record_lies_within_xla_cost_analysis_of_the_reference():
    """The JAX package's decode program at the same config: its XLA cost
    record hashes to the same key, and the analytic products lie within
    ``_XLA_RATIO`` of its FLOPs."""
    cfg, env = _CFGS["tiny"]
    jm = jserving.DecodeModel(jserving.GPTConfig(**cfg), seed=1, **env)
    jm.warm()
    ref = jm.insights.get("decode")
    if ref is None or not ref.flops:
        pytest.skip("the JAX package records no XLA cost analysis here")
    cost = _model("tiny").insights["decode"]
    assert cost.key_hash == ref.key_hash
    ratio = cost.flops / float(ref.flops)
    assert _XLA_RATIO[0] <= ratio <= _XLA_RATIO[1], ratio


_CALIB = {"flops_per_sec": 2.5e11, "bytes_per_sec": 4.0e10,
          "dispatch_s": 3e-6}


@pytest.mark.parametrize("active", [1.0, 3.5])
def test_decode_roofline_is_the_reference_document(active):
    """On the same cost numbers and calibration, the port's roofline is
    the JAX package's document, key for key and value for value."""
    cfg, env = _CFGS["tiny"]
    m = _model("tiny")
    jm = jserving.DecodeModel(jserving.GPTConfig(**cfg), seed=1, **env)
    jm.insights["decode"] = m.insights["decode"]
    got = m.decode_roofline(active, calibration=dict(_CALIB))
    want = jm.decode_roofline(active, calibration=dict(_CALIB))
    assert got == want
    assert got["program"] == m.insights["decode"].key_hash
    assert got["bound_by"] == "memory_s"


def test_decode_roofline_answers_on_the_cpu():
    """With no calibration given it probes the model's own device."""
    roof = _model("tiny").decode_roofline(2.0)
    assert set(roof) == {"legs", "bound_by", "tick_seconds_floor",
                         "mean_active", "predicted_tokens_per_sec", "flops",
                         "bytes_accessed", "calibration", "program"}
    assert roof["tick_seconds_floor"] == max(roof["legs"].values()) > 0
    assert np.isfinite(roof["predicted_tokens_per_sec"])


_TIGHT_S = 5.0  # the cold-start test's one deadline


def test_cold_start_shed_seeded_from_roofline(monkeypatch):
    """The reference's cold-start test (tests/test_serving.py) on the
    port, seeded from the port's own roofline: with an empty retirement
    EMA the shedder's estimate is the installed per-tick floor x the
    token budget. Both legs send the same request, deadline ``_TIGHT_S``
    (5 s): with no roofline (estimate 0) it is admitted; with the
    10-s-a-tick roofline (estimate 40 s) it is shed. The deadline is far
    above a loaded worker's admission delay, so neither leg races the
    clock (at 1 ms, the first leg's request was shed by the clock once
    a busy worker took 11 ms to admit it)."""
    monkeypatch.setenv("PADDLE_TPU_SERVE_SHED", "1")
    m = _model("tiny")
    eng = serving.ServingEngine(m)
    assert eng._service_ema == 0.0
    # no roofline installed: estimate 0, the tight request is admitted
    h0 = eng.submit([1, 2, 3], max_new_tokens=4, deadline_s=_TIGHT_S)
    eng.run_until_idle()
    assert len(h0.result(timeout=10)) == 4
    serving_ledger.reset()
    eng2 = serving.ServingEngine(m)
    # a calibration slow enough that a tick's floor is 10 s
    roof = m.decode_roofline(1.0, calibration={
        "flops_per_sec": 1.0, "bytes_per_sec": 1.0, "dispatch_s": 10.0})
    floor = roof["tick_seconds_floor"]
    assert floor >= 10.0
    serving_ledger.set_roofline(roof)
    assert eng2._service_estimate(serving.ServeRequest(
        request_id="x", max_new_tokens=4)) == pytest.approx(4 * floor)
    assert 4 * floor > _TIGHT_S
    tight = eng2.submit([1, 2, 3], max_new_tokens=4, deadline_s=_TIGHT_S)
    eng2.run_until_idle()
    with pytest.raises(errors.Unavailable, match="shed"):
        tight.result(timeout=1)
    # the retirement EMA, once taught, overrides the roofline seed
    loose = eng2.submit([1, 2, 3], max_new_tokens=2,
                        deadline_s=4 * floor + 120.0)
    eng2.run_until_idle()
    loose.result(timeout=10)
    assert 0.0 < eng2._service_ema < floor
    h2 = eng2.submit([1, 2, 3], max_new_tokens=4, deadline_s=60.0)
    eng2.run_until_idle()
    assert len(h2.result(timeout=10)) == 4


def test_dispatch_leg_is_host_wall_time(monkeypatch):
    """The dispatch probe is timed on the host clock around the launch and
    the wait (on the card, ``torch.cuda.synchronize``): a probe made slow
    on the host shows in the leg. The FLOP and byte probes keep the
    device clock (CUDA events on a card)."""
    clocks = []
    best = smodel._best

    def spy(fn, args, dev, host=False):
        clocks.append((getattr(fn, "__name__", ""), host))
        return best(fn, args, dev, host)

    monkeypatch.setattr(smodel, "_best", spy)
    fast = smodel.calibrate(device="cpu")
    assert set(clocks[:-2]) == {("matmul", False)}  # as it grows
    assert clocks[-2:] == [("mul", False), ("add", True)]
    add = torch.add

    def slow_add(*a, **k):
        time.sleep(0.03)
        return add(*a, **k)

    monkeypatch.setattr(torch, "add", slow_add)
    slow = smodel.calibrate(device="cpu")
    assert slow["dispatch_s"] >= 0.03 > fast["dispatch_s"]


@pytest.mark.parametrize("copy_mb,l2,elems", [
    (16, 0, 16 << 18),                # no cache: the probe as asked
    (16, 4 << 20, 16 << 18),          # a cache far below the probe
    (16, 50 << 20, 2 * (50 << 18)),   # an H100's 50 MB L2: twice it
    (256, 50 << 20, 256 << 18),       # a probe already beyond it
])
def test_copy_probe_is_sized_beyond_the_l2(copy_mb, l2, elems):
    assert smodel._copy_elems(copy_mb, l2) == elems


@pytest.mark.parametrize("rate,sides", [
    (67e12, [384, 768, 1536, 3072, 6144]),  # an H100's fp32 data sheet
    (1e11, [384]),                          # a CPU core: 1.1 ms at 384
    (1e18, [384, 768, 1536, 3072, 6144, 8192]),  # capped
])
def test_matmul_probe_grows_until_it_takes_a_millisecond(monkeypatch, rate,
                                                         sides):
    """The matmul probe doubles its side until one product takes 1 ms or
    the side reaches its cap, and calibrate's rate is the last size's:
    products timed at ``rate`` FLOP/s read ``rate``."""
    seen = []

    def timed(fn, args, dev, host=False):
        if fn is torch.matmul:
            n = args[0].shape[0]
            seen.append(n)
            return 2.0 * n ** 3 / rate
        return 1e-3

    monkeypatch.setattr(smodel, "_best", timed)
    monkeypatch.setattr(torch, "ones", lambda *shape, device=None:
                        torch.empty(*shape, device="meta"))
    cal = smodel.calibrate(device="cpu")
    assert seen == sides
    assert cal["flops_per_sec"] == pytest.approx(rate, rel=1e-12)
