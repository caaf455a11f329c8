"""The port's serving engine: the JAX package's engine tests, run on the
port at the tiny config on the CPU, and the whole slice against
``paddle_tpu.serving.ServingEngine`` (same prompts, same greedy tokens,
same ledger decode-token total). Parameters are the O(1)-scale random
ones of test_torch_serving_model, so greedy tokens vary from step to
step."""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving import ledger as jledger
from paddle_tpu_torch import errors
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving import ledger as serving_ledger
from paddle_tpu_torch.serving.kv_cache import BlockAllocator
from test_torch_serving_model import rich_params

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=64)
_ENV = dict(max_batch=4, n_blocks=16, block_size=8, prefill_buckets=[16, 32])


@pytest.fixture(scope="module")
def tiny_model():
    return serving.DecodeModel(serving.GPTConfig(**_CFG), params=rich_params(),
                               device="cpu", **_ENV)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    serving_ledger.reset()
    jledger.reset()
    yield
    serving_ledger.reset()
    jledger.reset()


def _prompts():
    r = np.random.RandomState(0)
    return [list(r.randint(1, 128, size=n)) for n in (5, 11, 7, 14)]


def test_admission_queue_slo_ordering(tiny_model):
    """The queue admits by absolute deadline, not arrival: a max_batch=1
    engine must complete a late-arriving tight-SLO request first."""
    q = serving.AdmissionQueue()
    q.push(serving.ServeRequest(request_id="loose", deadline_s=100.0,
                                t_submit=0))
    q.push(serving.ServeRequest(request_id="tight", deadline_s=1.0,
                                t_submit=0))
    assert q.pop().request_id == "tight"
    assert q.pop().request_id == "loose"

    eng = serving.ServingEngine(tiny_model, max_batch=1)
    h1 = eng.submit([3, 4, 5], max_new_tokens=2, deadline_s=100.0)
    h2 = eng.submit([6, 7], max_new_tokens=2, deadline_s=1.0)
    eng.run_until_idle()
    assert h1.done and h2.done
    assert h2._req.t_done < h1._req.t_done


def test_continuous_batching_bit_match(tiny_model):
    """Batched continuous decode gives BIT-IDENTICAL tokens to sequential
    decode, and both match greedy decoding of the full-context
    reference."""
    prompts = _prompts()
    eng = serving.ServingEngine(tiny_model)
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    batched = [h.result(timeout=5) for h in handles]
    # 6 tokens = 1 from prefill + 5 decode ticks, each request
    assert serving_ledger.totals()["decode_tokens"] == 4 * 5

    eng_seq = serving.ServingEngine(tiny_model)
    sequential = []
    for p in prompts:
        h = eng_seq.submit(p, max_new_tokens=6)
        eng_seq.run_until_idle()
        sequential.append(h.result(timeout=5))
    assert batched == sequential

    for p, got in zip(prompts, batched):
        toks = list(p)
        for _ in range(6):
            toks.append(int(tiny_model.full_logits(np.asarray(toks))[0, -1]
                            .argmax()))
        assert toks[len(p):] == got


def test_kv_eviction_under_pressure(tiny_model):
    """Under KV exhaustion a tight-SLO arrival preempts the loosest
    running request, which resumes (recompute) and still delivers its
    full token budget."""
    eng = serving.ServingEngine(tiny_model)
    eng.allocator = BlockAllocator(4, block_size=8)  # 3 usable blocks
    r = np.random.RandomState(1)
    loose = eng.submit(list(r.randint(1, 128, size=20)), max_new_tokens=3,
                       deadline_s=100.0)
    eng.step()  # admit + prefill the loose request (holds 3 blocks)
    assert len(loose._req.blocks) == 3 and eng.allocator.available() == 0
    tight = eng.submit([9, 8, 7], max_new_tokens=2, deadline_s=0.5)
    eng.run_until_idle()
    assert tight.result(timeout=5) and loose.result(timeout=5)
    assert loose._req.evictions >= 1
    assert set(tight._req.blocks) == set()  # freed after retirement
    assert len(loose.result(timeout=5)) == 3
    doc = serving_ledger.totals()
    assert doc["requests"].get("evicted", 0) >= 1
    assert doc["requests"].get("ok", 0) == 2


def test_never_fitting_request_fails_fast(tiny_model):
    """A trajectory the cache can never hold fails at admission instead
    of requeueing forever."""
    eng = serving.ServingEngine(tiny_model)
    eng.allocator = BlockAllocator(3, block_size=8)  # 2 usable blocks
    h = eng.submit(list(range(1, 21)), max_new_tokens=2, deadline_s=5.0)
    eng.run_until_idle()
    assert h.done
    with pytest.raises(errors.InvalidArgument, match="KV blocks"):
        h.result(timeout=1)
    assert eng.queue.depth() == 0 and not eng.active()
    assert serving_ledger.totals()["requests"].get("failed", 0) == 1


def test_threaded_engine_serves(tiny_model):
    """start() serves from the scheduler thread (which binds the model's
    device first) and stop() joins it."""
    eng = serving.ServingEngine(tiny_model)
    eng.start()
    try:
        got = eng.submit([5, 9, 3, 44, 17], max_new_tokens=4,
                         deadline_s=30.0).result(timeout=30)
    finally:
        eng.stop(flush=False)
    assert len(got) == 4 and not eng.running_thread()


def test_slice_matches_the_jax_engine(tiny_model):
    """The whole slice: the same prompts through both packages' engines
    give the same greedy tokens and the same decode-token total."""
    prompts = _prompts()
    jm = jserving.DecodeModel(jserving.GPTConfig(**_CFG),
                              params=rich_params(), **_ENV)
    jeng = jserving.ServingEngine(jm)
    jh = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run_until_idle()
    want = [h.result(timeout=5) for h in jh]

    eng = serving.ServingEngine(tiny_model)
    th = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    assert [h.result(timeout=5) for h in th] == want
    assert (serving_ledger.totals()["decode_tokens"]
            == jledger.totals()["decode_tokens"] == 4 * 5)
