"""``chip_smoke.py``'s ``serve_tier`` phase on the CPU, at a tiny config.

The phase runs replica processes (``tools/torch_serve_replica.py``)
behind a ``Router``: traffic, a SIGKILL failover, a respawn and drain,
each replica's roofline from /status, ``capacity.plan`` and one drain-first
``Autoscaler`` scale-down. On the card it runs at the serving config's
full width; here the same code runs with ``device="cpu"`` on a 2-layer,
64-wide model with 40 new tokens a request (long enough that requests
are still out when the phase kills or drains a replica), against tokens
import torch_threads  # noqa: F401 (one torch thread a worker)
from an in-process engine; each replica process runs one CPU thread.
Then its checks are shown failing where they should: changed tokens,
and a decode tick that beats its floor.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.serving import (DecodeModel, GPTConfig,  # noqa: E402
                                      ServingEngine, init_params)
from paddle_tpu_torch.serving import ledger as serving_ledger  # noqa: E402

_CFG = dict(vocab_size=256, n_layer=2, n_head=2, d_model=64,
            max_seq_len=128)
_ENV = dict(max_batch=4, n_blocks=96, block_size=8, prefill_buckets=[32, 64])
_NEW = 40


@pytest.fixture()
def tiny_tier(monkeypatch):
    """The phase's config cut to the tiny one, its prompts and the
    in-process engine's tokens for them."""
    monkeypatch.setattr(cs, "_SERVE_CFG", _CFG)
    monkeypatch.setattr(cs, "_SERVE_ENV", _ENV)
    monkeypatch.setattr(cs, "_NEW_TOKENS", _NEW)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the replicas' threads
    serving_ledger.reset()
    cfg = GPTConfig(**_CFG)
    model = DecodeModel(cfg, params=init_params(cfg, seed=0), device="cpu",
                        **_ENV)
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 256, size=n).tolist()
               for n in (3, 5, 9, 12, 17, 20, 25, 30)]
    eng = ServingEngine(model)
    handles = [eng.submit(p, max_new_tokens=_NEW, deadline_s=3600.0)
               for p in prompts]
    eng.run_until_idle()
    want = [h.result(timeout=60) for h in handles]
    yield prompts, want
    serving_ledger.reset()


def test_serve_tier_runs_on_the_cpu(tiny_tier, capsys):
    prompts, want = tiny_tier
    # a CPU tick is far slower than the card's floor; the phase holds the
    # card's replayed tick, so a CPU run passes a slow one in its place
    cs._serve_tier(torch, "cpu", prompts, want,
                   {"device_ms_per_tick": 1e4}, device="cpu")
    line = [x for x in capsys.readouterr().out.splitlines()
            if '"phase": "serve_tier"' in x]
    assert len(line) == 1
    doc = cs.json.loads(line[0])
    assert doc["tokens_equal_in_process_replayed"] is True
    assert doc["bitmatch_mismatch"] == 0
    assert doc["failover"]["redispatched"] >= 1
    assert doc["failover"]["detected_by"] in ("connect", "healthz_failed")
    assert doc["drain"]["healthz"]["drained"] is True
    assert doc["drain"]["new_work_on"] == ["replica0"]
    assert doc["autoscale"]["actions"] == ["drain_start", "scale_down"]
    assert doc["autoscale"]["stopped_exit_codes"] == {"replica2": 0}
    for roof in doc["roofline"].values():
        assert roof["cost"]["flops"] > 0
        assert roof["roofline_reconciliation"]["available"]
    assert doc["plan"]["verdict"] in ("ok", "no_feasible_config")


def test_serve_tier_rejects_changed_tokens():
    recs = [{"request_id": "a", "ok": True, "tokens": [1, 2]},
            {"request_id": "b", "ok": True, "tokens": [3, 4]}]
    cs._hold_tokens(recs, [[1, 2], [3, 4]], "leg")
    with pytest.raises(AssertionError, match=r"\['b'\]"):
        cs._hold_tokens(recs, [[1, 2], [3, 5]], "leg")
    recs[0].update(ok=False, error="boom")
    with pytest.raises(AssertionError, match="failed"):
        cs._hold_tokens(recs, [[1, 2], [3, 4]], "leg")


class _StatusStub:
    """A replica whose /status carries the given roofline."""

    name = "stub"

    def __init__(self, roofline, ratio):
        cost = {"flops": roofline["flops"],
                "bytes_accessed": roofline["bytes_accessed"],
                "key_hash": roofline["program"]}
        self.ready = {"decode_cost": cost}
        self.doc = {"serving": {"roofline": roofline,
                                "roofline_reconciliation": {
                                    "ratio": ratio,
                                    "verdict": "within_bound"}}}

    def get(self, path):
        return self.doc


def _roofline(floor_s):
    return {"flops": 2.0e9, "bytes_accessed": 1.0e9, "program": "k",
            "legs": {"compute_s": floor_s / 2, "memory_s": floor_s,
                     "dispatch_s": 1e-5},
            "bound_by": "memory_s", "tick_seconds_floor": floor_s,
            "calibration": {}}


def test_tier_roofline_rejects_a_tick_beating_its_floor():
    """A replayed tick faster than a floor by more than the headroom, or
    a measured rate above headroom x predicted, means a wrong bound."""
    ok = cs._tier_roofline(_StatusStub(_roofline(0.4e-3), 0.5),
                           {"device_ms_per_tick": 3.0})
    assert ok["device_ms_over_floor"]["calibrate"] == pytest.approx(7.5)
    with pytest.raises(AssertionError, match="calibrate floor"):
        cs._tier_roofline(_StatusStub(_roofline(4e-3), 0.5),
                          {"device_ms_per_tick": 2.0})
    with pytest.raises(AssertionError, match="data_sheet floor"):
        cs._tier_roofline(_StatusStub(_roofline(1e-6), 0.5),
                          {"device_ms_per_tick": 0.1})
    with pytest.raises(AssertionError, match="roofline's prediction"):
        cs._tier_roofline(_StatusStub(_roofline(0.4e-3), 1.6),
                          {"device_ms_per_tick": 3.0})
