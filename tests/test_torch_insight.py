"""The port's compiled-program insight (``paddle_tpu_torch/framework/
xla_insight.py``) on the CPU, beside the JAX package's.

The JAX package's sequences (``tests/test_xla_insight.py``) on the port's
executor, at the tiny GPT: one cost record per cache entry (startup and
train step), its gauges and its capture counter, none with
``PADDLE_TPU_XLA_INSIGHT=0``, no second record for a cached entry, the
dump directory (the op list in place of the jaxpr, ``cost.json``
written last, read back by ``load_dump_dir``) and the static footprint,
equal to the JAX package's on the same program. The record is taken on
the entry's first run, which is eager on both routes, never at a
capture.

FLOPs: the port counts the products (``FlopCounterMode``; on the CPU the
kernels' plain versions run, and their products are counted) where XLA
counts every operation, the elementwise work too. At this config the
train step's count is 0.83 of XLA's, held here to [0.7, 1.0]; and it
equals ``chip_smoke._analytic_step_flops`` exactly (the plain
versions' attention over all T^2 scores, no Adam products), the count
``train_observed`` holds the card's record to.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.framework import xla_insight as jinsight
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch import monitor
from paddle_tpu_torch.framework import CPUPlace, Executor, Scope
from paddle_tpu_torch.framework import xla_insight as insight
from paddle_tpu_torch.weights import scope_from_numpy
from test_torch_replay import _B, _CFG, _batch, _program
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_XLA_RATIO = (0.7, 1.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("PADDLE_TPU_XLA_INSIGHT", "PADDLE_TPU_XLA_DUMP_DIR"):
        monkeypatch.delenv(k, raising=False)
    monitor.enable(True)
    monitor.reset_metrics()
    insight.clear_recent()
    yield


def _port(steps=3, staged=False):
    main, startup, io, _ = _program()
    scope, exe = Scope(), Executor(CPUPlace())
    exe.staged = staged
    exe.run(startup, scope=scope)
    feed = _batch(_CFG)
    for _ in range(steps):
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    return exe, main, scope


def _jax():
    """(compiled_insights, program_footprint, start) of the JAX package's
    tiny GPT after one step."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, dtype="float32")
            main, startup, io = jgpt.build_train_program(
                cfg, _B, _CFG["max_seq_len"])
            with jguard(main, startup):
                JAdam(learning_rate=1e-3).minimize(io["loss"])
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
        start = {v.name: np.asarray(scope.get(v.name))
                 for v in main.list_vars() if v.persistable}
        exe.run(main, feed=_batch(_CFG), fetch_list=[io["loss"]],
                scope=scope)
        return (exe.compiled_insights(), jinsight.program_footprint(
            main, scope), start)
    finally:
        pd.disable_static()


def _series(name):
    fam = monitor.snapshot()["metrics"].get(name, {})
    return fam.get("series", [])


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_cost_record_per_entry_metrics_and_dump(staged, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_XLA_DUMP_DIR", str(tmp_path))
    exe, main, _ = _port(steps=3, staged=staged)
    records = exe.compiled_insights()
    assert len(records) == 2  # the startup program and the train step
    rec = max(records, key=lambda r: r["flops"])
    assert rec["schema"] == insight.COST_SCHEMA == jinsight.COST_SCHEMA
    assert rec["flops"] > 0 and rec["cost_raw"]["product flops"] > 0
    assert rec["fetch_names"] and rec["label"] == rec["fetch_names"][0]
    assert rec["n_jaxpr_eqns"] == sum(
        op.type not in ("feed", "fetch") for op in main.global_block().ops)
    assert rec["argument_bytes"] > 0 and rec["output_bytes"] > 0
    # no torch twin: named None (the module docstring says why)
    for k in ("bytes_accessed", "alias_bytes", "generated_code_bytes",
              "collectives"):
        assert rec[k] is None, k
    # the CPU has no allocator statistics
    assert rec["peak_bytes"] is None and rec["temp_bytes"] is None
    series = {s["labels"]["program"]: s["value"]
              for s in _series("program_flops")}
    assert series[rec["key_hash"]] == rec["flops"]
    ok = [s["value"] for s in _series("xla_insight_captures_total")
          if s["labels"]["result"] == "ok"]
    assert ok == [2.0]  # one record per entry, not per run
    # the dump: the op list, then cost.json (last), read back alike
    loaded = insight.load_dump_dir(str(tmp_path))
    assert set(loaded) == {r["key_hash"] for r in records}
    got = loaded[rec["key_hash"]]
    assert got["flops"] == rec["flops"]
    ops = tmp_path / f"program.{rec['key_hash']}.ops"
    cost = tmp_path / f"program.{rec['key_hash']}.cost.json"
    assert got["artifacts"]["ops"] == str(ops)
    assert os.path.getmtime(ops) <= os.path.getmtime(cost)
    lines = ops.read_text().splitlines()
    assert len(lines) == len(main.global_block().ops)
    assert lines[0].startswith("0:0 ") and "lookup_table_v2" in lines[0]
    assert "dot" not in got["artifacts"]  # CUDA graphs: the card only
    assert json.loads(cost.read_text())["key_hash"] == rec["key_hash"]


def test_record_is_taken_on_the_first_run_never_a_capture(monkeypatch):
    calls = []
    real = insight.recording

    def spy(device):
        calls.append(dict(exe.phases))
        return real(device)

    monkeypatch.setattr(insight, "recording", spy)
    main, startup, io, _ = _program()
    scope, exe = Scope(), Executor(CPUPlace())
    exe.staged = True
    exe.run(startup, scope=scope)
    for _ in range(4):
        exe.run(main, feed=_batch(_CFG), fetch_list=[io["loss"]],
                scope=scope)
    # startup's warm-up and main's warm-up: no phase had run yet for
    # either entry when its record began
    assert len(calls) == 2
    assert calls[1] == {"eager": 1, "capture": 0, "replay": 0}
    assert exe.phases == {"eager": 2, "capture": 1, "replay": 2}


def test_record_disabled_by_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_XLA_INSIGHT", "0")
    exe, _, _ = _port(steps=2)
    assert exe.compiled_insights() == []
    assert insight.recent() == []


def test_structure_hash_is_stable_across_executors():
    a, _, _ = _port(steps=1)
    b, _, _ = _port(steps=1)
    assert sorted(r["key_hash"] for r in a.compiled_insights()) == sorted(
        r["key_hash"] for r in b.compiled_insights())


def test_flops_against_the_reference_and_the_analytic_count():
    jrecs, _, _ = _jax()
    exe, main, _ = _port(steps=1)
    port = max(r["flops"] for r in exe.compiled_insights())
    xla = max(r["flops"] for r in jrecs)
    assert _XLA_RATIO[0] <= port / xla <= _XLA_RATIO[1], port / xla
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    analytic = chip_smoke._analytic_step_flops(
        dict(_CFG), _B, _CFG["max_seq_len"], n_params, flash=False,
        plain=True)
    assert port == analytic["total"]
    assert chip_smoke._insight_agrees(
        [max(exe.compiled_insights(), key=lambda r: r["flops"])],
        analytic)["ratio"] == 1.0


def test_kernel_costs_count_only_while_recording():
    insight.note_kernel("lmhead_ce_fwd", 10.0, 4.0)  # nothing open
    with insight.recording("cpu") as rec:
        insight.note_kernel("lmhead_ce_fwd", 10.0, 4.0)
        insight.note_kernel("lmhead_ce_fwd", 10.0, 4.0)
        insight.note_kernel("fused_adam", 3.0, 1.0)
        assert insight.active()
    assert not insight.active()
    assert rec.kernels == {"lmhead_ce_fwd": {"flops": 20.0, "bytes": 8.0,
                                             "launches": 2},
                           "fused_adam": {"flops": 3.0, "bytes": 1.0,
                                          "launches": 1}}
    got = insight.record(rec, key_hash="abc", n_ops=3)
    assert got.flops == 23.0 and got.cost_raw["fused_adam launches"] == 1


def test_flash_visible_scores_match_the_mask():
    from paddle_tpu_torch.ops.flash_attention import visible_scores

    for tq in range(0, 9):
        for tk in range(0, 9):
            want = sum(min(tk, max(0, i + 1 + tk - tq)) for i in range(tq))
            assert visible_scores(tq, tk, True) == want
            assert visible_scores(tq, tk, False) == tq * tk


def test_footprint_equals_the_reference():
    _, jfp, start = _jax()
    main, _, _, _ = _program()
    scope = scope_from_numpy(start, Scope(), "cpu")
    fp = insight.program_footprint(main, scope)
    assert fp == jfp
    assert fp["total_param_bytes"] > 0 and fp["total_opt_state_bytes"] > 0
    assert monitor.stat_get("model_param_bytes") == fp["total_param_bytes"]
