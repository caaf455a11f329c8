"""The port's device-memory observability (``paddle_tpu_torch/memwatch.py``,
``device.py``) against the JAX package's.

The JAX package's own sequences (``tests/test_memwatch.py``) run through
both packages' ledgers with the same normalized samples: step watermarks
and deltas, the goodput step boundary, the bounded /status tail, the leak
detector (one event per episode, the minimum growth), journal flush,
resume, the not-pristine guard, the cross-rank merge, the reconciliation
bound, a rank change and the disabled mode give equal documents (clock
and pid fields aside). Then the port alone: ``device.memory_stats`` on
the CPU (the synthetic source: the live scopes' tensors), the executor's
sampling on a tiny GPT program, and an allocation failure raised inside
an op, at an eager run and at a capture, turned into the typed
``ResourceExhausted`` naming that op, with the post-mortem beside the
program dumps.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu import goodput as jgoodput
from paddle_tpu import memwatch as jmemwatch
from paddle_tpu import monitor as jmonitor
from paddle_tpu_torch import device, goodput, memwatch, monitor
from paddle_tpu_torch.framework import Scope, errors, registry
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_PACKAGES = ((memwatch, goodput, monitor), (jmemwatch, jgoodput, jmonitor))
_VOLATILE = ("time_unix", "pid", "t", "started_unix")
_TINY = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16,
             max_seq_len=32)


@pytest.fixture(autouse=True)
def _fresh():
    saved = [(mw, mw._JOURNAL_DIR) for mw, _, _ in _PACKAGES]
    for mw, gp, mon in _PACKAGES:
        mon.enable(True)
        mw.reset()
        gp.reset()
    yield
    for mw, d in saved:
        mw._JOURNAL_DIR = d
    for mw, gp, _ in _PACKAGES:
        mw.reset()
        gp.reset()


def _stable(doc):
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def _feed(mw, in_use, peak=None):
    mw.sample(stats={"bytes_in_use": in_use,
                     "peak_bytes_in_use": peak or in_use,
                     "bytes_limit": 16_000_000_000, "source": "synthetic"})


def _watermarks(mw, gp, tmp):
    _feed(mw, 100)
    _feed(mw, 300)  # intra-step spike
    _feed(mw, 200)
    a = mw.end_step(step=7)
    _feed(mw, 260)
    b = mw.end_step(step=8)
    return [a, b, mw.totals()]


def _no_samples(mw, gp, tmp):
    led = mw.MemLedger()
    return [led.end_step(), led.steps]


def _goodput_boundary(mw, gp, tmp):
    _feed(mw, 1000)
    gp.add("device_compute", 0.01)
    gp.end_step(0.02, step=3)
    return [mw.totals()]


def _bounded_tail(mw, gp, tmp):
    for i in range(30):
        _feed(mw, 100 + i)
        mw.end_step(step=i)
    doc = mw.status()
    return [doc, len(doc["step_tail"]), "step_series" in doc]


def _leak_episodes(mw, gp, tmp):
    os.environ["PADDLE_TPU_MEMWATCH_LEAK_STEPS"] = "4"
    os.environ["PADDLE_TPU_MEMWATCH_LEAK_MIN_MB"] = "0.000001"
    base, closed = 1_000_000, []
    for i in range(1, 9):
        _feed(mw, base + i * 1000)
        closed.append(mw.end_step(step=i))
    for i in range(9, 12):
        _feed(mw, base + 8000)
        closed.append(mw.end_step(step=i))
    for i in range(12, 17):
        _feed(mw, base + 8000 + (i - 11) * 1000)
        closed.append(mw.end_step(step=i))
    return closed + [mw.totals()["leak_events"]]


def _leak_min_growth(mw, gp, tmp):
    os.environ["PADDLE_TPU_MEMWATCH_LEAK_STEPS"] = "3"
    os.environ["PADDLE_TPU_MEMWATCH_LEAK_MIN_MB"] = "1.0"
    closed = []
    for i in range(1, 10):
        _feed(mw, 1_000_000 + i * 10)
        closed.append(mw.end_step(step=i))
    return closed + [mw.totals()["leak_events"]]


def _journal_resume(mw, gp, tmp):
    _feed(mw, 500)
    mw.end_step(step=1)
    _feed(mw, 900)
    mw.end_step(step=2)
    doc = json.load(open(mw.flush(str(tmp / "memwatch.rank0.json"))))
    mw.reset()
    mw.configure(dir=str(tmp))
    _feed(mw, 300)
    mw.end_step(step=3)
    out = [doc, mw.totals()]
    mw.disable_persistence()
    return out


def _not_pristine(mw, gp, tmp):
    _feed(mw, 500)
    mw.end_step(step=1)
    mw.flush(str(tmp / "memwatch.rank0.json"))
    mw.configure(dir=str(tmp))
    out = [mw.totals()]
    mw.disable_persistence()
    return out


def _merge_ranks(mw, gp, tmp):
    for rank, peak in ((0, 700), (1, 1100)):
        doc = {"schema": mw.SCHEMA, "rank": rank, "steps": 5,
               "lifetime_peak_bytes": peak, "bytes_in_use": peak - 100,
               "leak_events": rank, "source": "device",
               "bytes_limit": 16_000_000_000}
        (tmp / f"memwatch.rank{rank}.json").write_text(json.dumps(doc))
    merged = mw.load_journals(str(tmp))
    return [merged, mw.load_journals(str(tmp), ranks=[1]),
            mw.render_summary(merged)]


def _reconcile(mw, gp, tmp):
    return [mw.reconcile(estimates=[1000, 4000], measured_peak=6000),
            mw.reconcile(estimates=[1000], measured_peak=50_000),
            mw.reconcile(estimates=[], measured_peak=5000)]


def _rank_change(mw, gp, tmp):
    mon = jmonitor if mw is jmemwatch else monitor
    mw.configure(dir=str(tmp))
    _feed(mw, 700)
    mw.end_step(step=1)
    mw.flush()
    mw.reset()
    mw.configure(dir=str(tmp))  # resumes rank 0's journal
    resumed = mw.totals()["steps"]
    mon.set_trainer_rank(3)  # late identity: rank 3 has no journal
    try:
        after = mw.totals()["steps"]
        _feed(mw, 100)
        mw.end_step(step=2)
        doc = mw.load_journal(mw.flush())
    finally:
        mon.set_trainer_rank(0)
        mw.disable_persistence()
    return [resumed, after, doc]


def _disabled(mw, gp, tmp):
    os.environ["PADDLE_TPU_MEMWATCH"] = "0"
    return [mw.sample(), mw.end_step(), mw.totals()["samples"]]


_SEQUENCES = [_watermarks, _no_samples, _goodput_boundary, _bounded_tail,
              _leak_episodes, _leak_min_growth, _journal_resume,
              _not_pristine, _merge_ranks, _reconcile, _rank_change,
              _disabled]


_ENV = ("PADDLE_TPU_MEMWATCH_LEAK_STEPS", "PADDLE_TPU_MEMWATCH_LEAK_MIN_MB",
        "PADDLE_TPU_MEMWATCH")


@pytest.mark.parametrize("seq", _SEQUENCES,
                         ids=[s.__name__.strip("_") for s in _SEQUENCES])
def test_same_calls_same_memory_ledger(seq, tmp_path, monkeypatch):
    for k in _ENV:  # restored when the test ends
        monkeypatch.delenv(k, raising=False)
    got = []
    for (mw, gp, _), name in zip(_PACKAGES, ("port", "reference")):
        d = tmp_path / name
        d.mkdir()
        got.append(_stable(seq(mw, gp, d)))
        for k in _ENV:
            os.environ.pop(k, None)
    assert got[0] == got[1]


def test_sequences_say_what_the_reference_asserts(tmp_path, monkeypatch):
    """The reference's headline numbers, on the port's side."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    a, b, t = _watermarks(memwatch, goodput, tmp_path)
    assert (a["watermark_bytes"], a["bytes_in_use"], a["delta_bytes"]) == (
        300, 200, 0)
    assert b["delta_bytes"] == 60 and t["lifetime_peak_bytes"] == 300
    memwatch.reset()
    closed = _leak_episodes(memwatch, goodput, tmp_path)
    first = next(c for c in closed[:-1] if c.get("leak"))
    assert first["step"] == 5 and first["leak"]["steps"] == 4
    assert closed[-1] == 2
    memwatch.reset()
    resumed, after, doc = _rank_change(memwatch, goodput, tmp_path)
    assert (resumed, after, doc["rank"], doc["steps"]) == (1, 0, 3, 1)


# ---------------------------------------------------------------------------
# the port alone: device.memory_stats, the executor's hooks
# ---------------------------------------------------------------------------


def test_memory_stats_cpu_counts_the_live_scopes():
    stats = device.memory_stats("cpu")
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "source", "platform", "device_id"):
        assert key in stats, key
    assert stats["source"] == "synthetic" and stats["platform"] == "cpu"
    scope = Scope()
    before = device.memory_stats("cpu")["bytes_in_use"]
    big = torch.zeros(1024, 1024)
    scope.set("big", big)
    scope.set("view", big[:10])  # a view of the same storage: once
    after = device.memory_stats("cpu")
    assert after["bytes_in_use"] == before + 4 * 2 ** 20
    peak = after["peak_bytes_in_use"]
    scope.erase("big")
    scope.erase("view")
    del big
    later = device.memory_stats("cpu")
    assert later["bytes_in_use"] == before
    assert later["peak_bytes_in_use"] >= peak  # the peak is sticky
    device.reset_peak_memory_stats("cpu")
    stats = device.memory_stats("cpu")
    assert stats["peak_bytes_in_use"] == stats["bytes_in_use"]
    assert device.device_count() == torch.cuda.device_count()
    device.synchronize("cpu")
    assert device.get_device_properties("cpu")["platform"] == "cpu"


def _tiny_train():
    program = chip_smoke._train_program(_TINY, 2, 8)
    main, startup, io = program
    scope, exe = Scope(), chip_smoke._executor("cpu")
    exe.run(startup, scope=scope)
    feed = chip_smoke._fixed_batch(torch, _TINY["vocab_size"], 2, 8, "cpu")
    return exe, main, scope, feed, io["loss"]


def test_executor_run_samples_memory(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MEMWATCH_SAMPLE_RUNS", "2")
    exe, main, scope, feed, loss = _tiny_train()
    samples = memwatch.totals()["samples"]
    for i in range(5):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        goodput.end_step(time.perf_counter() - t0, step=i)
    t = memwatch.totals()
    # run 1 builds (sampled); then every 2nd run, and each closed step
    # with no sample of its own samples at its end
    assert t["samples"] - samples == 5
    assert t["steps"] == 5 and t["lifetime_peak_bytes"] > 0
    assert t["source"] == "synthetic"
    reg = monitor.default_registry()
    assert reg.get("hbm_peak_bytes").value == t["lifetime_peak_bytes"]


def _raise_oom_in(monkeypatch, op_type, only_capture=False):
    """Every lowering of ``op_type`` raises the caching allocator's error
    (at a capture only, with ``only_capture``)."""
    real = registry.run_lowering

    def lowering(opdef, ctx, ins, attrs):
        if opdef.type == op_type and (ctx.replayed or not only_capture):
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 64.00 GiB")
        return real(opdef, ctx, ins, attrs)

    monkeypatch.setattr(registry, "run_lowering", lowering)


@pytest.mark.parametrize("route", ["eager", "capture"])
def test_oom_is_typed_with_the_raising_op(route, tmp_path, monkeypatch):
    """An allocation failure inside an op (the first ``adam``), at an
    eager run or at the staged route's capture, raises the typed
    ResourceExhausted naming that op, with the post-mortem (footprint by
    layer, hints) written next to the program dumps."""
    monkeypatch.setenv("PADDLE_TPU_XLA_DUMP_DIR", str(tmp_path))
    exe, main, scope, feed, loss = _tiny_train()
    exe.staged = route == "capture"
    idx = next(i for i, op in enumerate(main.global_block().ops)
               if op.type == "adam")
    if route == "capture":
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # warm-up
    _raise_oom_in(monkeypatch, "adam", only_capture=route == "capture")
    with pytest.raises(errors.ResourceExhaustedError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    e = ei.value
    assert isinstance(e, errors.EnforceError)
    assert e.op_provenance.op_type == "adam"
    assert e.op_provenance.op_idx == idx
    assert f"raised in op #{idx} 'adam'" in str(e)
    assert isinstance(e.__cause__.__cause__, torch.cuda.OutOfMemoryError)
    if route == "capture":
        assert any("capturing" in n for n in e.__cause__.__notes__)
    report = e.memory_report
    assert report["schema"] == memwatch.POSTMORTEM_SCHEMA
    assert report["blame"]["op_type"] == "adam"
    assert report["blame"]["op_idx"] == idx
    assert report["footprint"]["total_param_bytes"] > 0
    assert report["footprint"]["total_opt_state_bytes"] > 0
    assert report["hints"] and "out of memory" in report["error"].lower()
    assert os.path.dirname(e.postmortem_path) == str(tmp_path)
    on_disk = json.load(open(e.postmortem_path))
    assert on_disk["blame"] == report["blame"]
    # the staged route's top programs carry its first run's cost record
    assert [p["program"] for p in report["top_programs"]] == [] or all(
        p["peak_bytes"] for p in report["top_programs"])


def test_non_oom_errors_pass_through(monkeypatch):
    exe, main, scope, feed, loss = _tiny_train()
    real = registry.run_lowering

    def lowering(opdef, ctx, ins, attrs):
        if opdef.type == "adam":
            raise RuntimeError("something unrelated went wrong")
        return real(opdef, ctx, ins, attrs)

    monkeypatch.setattr(registry, "run_lowering", lowering)
    with pytest.raises(errors.EnforceError, match="unrelated") as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert not isinstance(ei.value, errors.ResourceExhaustedError)


@pytest.mark.parametrize("exc,oom", [
    (RuntimeError("RESOURCE_EXHAUSTED: ..."), True),
    (RuntimeError("Out of memory allocating"), True),
    (errors.errors.ResourceExhausted("hbm"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ValueError("shape mismatch"), False),
    (RuntimeError("no room left, bloom filter"), False),
])
def test_is_oom_error_classification(exc, oom):
    assert memwatch.is_oom_error(exc) is oom
    assert jmemwatch.is_oom_error(exc) is oom
    wrapped = errors.EnforceError("an op failed")
    wrapped.__cause__ = exc
    assert memwatch.is_oom_error(wrapped) is oom


def test_reconcile_reads_the_insight_records():
    exe, main, scope, feed, loss = _tiny_train()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    rec = memwatch.reconcile(estimates=[r["peak_bytes"] for r in
                                        exe.compiled_insights()])
    # the CPU has no allocator peak: no estimate to hold the sample to
    assert rec["available"] is False
    assert np.isfinite(memwatch.totals()["lifetime_peak_bytes"])
