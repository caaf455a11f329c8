"""Static-graph save/load (``paddle_tpu_torch/static/io.py``) and the epoch
loop's auto-checkpoint (``paddle_tpu_torch/incubate/checkpoint/
auto_checkpoint.py``) on the CPU.

- A round trip of every persistable (fp32, and bf16 written as the exact
  float32 of its values) is bit for bit, into a fresh scope (new tensors
  of the program's dtypes) and into the scope that holds them (in
  place). ``save_params`` keeps the parameters alone; ``vars`` filters.
- The load rule: in place where the scope holds a tensor of the saved
  shape, so a captured step stays bound (the next run replays, from the
  loaded values, and equals the run it replaces bit for bit); otherwise
  a new tensor, which makes the step capture again.
- A file the JAX package's ``static.io.save_persistables`` wrote loads
  into the port's program with the JAX values.
- ``save_inference_model`` / ``load_inference_model`` round-trip the
  program pruned to the loss, bit for bit.
- ``TrainEpochRange`` over 2 epochs x 3 steps, crashed at epoch 1's
  start and resumed on a fresh executor and scope, equals the
  uninterrupted loop bit for bit on the staged route, and the drift
  audit passes on the goodput and dynamics journals across the restart
  (``chip_smoke._recovery``, the ``train_observed`` phase's own check);
  the resume gate (``PADDLE_RESTART_COUNT``), ``restored_from`` and the
  generator form behave as the JAX package's.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pd
from paddle_tpu import static as jstatic
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch import static
from paddle_tpu_torch.framework import CPUPlace, Executor, Scope
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as ac
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_TINY = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16,
             max_seq_len=32)
_B, _T = 2, 8


def _setup(dtype=None, staged=False):
    cfg = dict(_TINY, dtype=dtype) if dtype else dict(_TINY)
    program = chip_smoke._train_program(cfg, _B, _T)
    main, startup, io = program
    scope, exe = Scope(), Executor(CPUPlace())
    exe.staged = staged
    exe.run(startup, scope=scope)
    feed = chip_smoke._fixed_batch(torch, _TINY["vocab_size"], _B, _T, "cpu")
    return program, scope, exe, feed


def _state(main, scope):
    return {v.name: scope.get(v.name).clone() for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


def _equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_round_trip_is_bit_for_bit(dtype, tmp_path):
    (main, _, io), scope, exe, feed = _setup(dtype)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    want = _state(main, scope)
    saved = static.save_persistables(exe, str(tmp_path), main, scope=scope)
    assert sorted(saved) == sorted(want)
    with open(tmp_path / static.io.PARAMS_FILENAME, "rb") as f:
        data = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in data.values())
    fresh = Scope()
    static.load_persistables(exe, str(tmp_path), main, scope=fresh)
    _equal(_state(main, fresh), want)
    # into the scope that holds them: in place, the same tensors
    held = {n: scope.get(n) for n in want}
    for t in held.values():
        t.zero_()
    static.load_persistables(exe, str(tmp_path), main, scope=scope)
    assert all(scope.get(n) is held[n] for n in want)
    _equal(_state(main, scope), want)


def test_save_params_and_vars_filter(tmp_path):
    (main, _, io), scope, exe, feed = _setup()
    names = static.save_params(exe, str(tmp_path / "p"), main, scope=scope)
    assert sorted(names) == sorted(p.name for p in main.all_parameters())
    some = [main.all_parameters()[0]]
    got = static.save_vars(exe, str(tmp_path / "v"), main, vars=some,
                           scope=scope)
    assert got == [some[0].name]
    fresh = Scope()
    loaded = static.load_vars(exe, str(tmp_path / "p"), main,
                              vars=[some[0].name], scope=fresh)
    assert loaded == [some[0].name]
    assert torch.equal(fresh.get(some[0].name), scope.get(some[0].name))


def test_in_place_load_keeps_the_captured_step(tmp_path):
    (main, _, io), scope, exe, feed = _setup(staged=True)
    losses = [exe.run(main, feed=feed, fetch_list=[io["loss"]],
                      scope=scope)[0] for _ in range(3)]
    static.save_persistables(exe, str(tmp_path), main, scope=scope)
    step4 = exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    state4 = _state(main, scope)
    exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    static.load_persistables(exe, str(tmp_path), main, scope=scope)
    (entry,) = [e for e in exe._cache.values() if e.compiled is not None
                and e.fetch_names == (io["loss"].name,)]
    assert entry.compiled.bound_to(scope)
    phases = dict(exe.phases)
    again = exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    assert exe.phases["replay"] == phases["replay"] + 1
    assert exe.phases["capture"] == phases["capture"]
    assert float(again[0]) == float(step4[0]) and len(losses) == 3
    _equal(_state(main, scope), state4)


def test_replacing_load_captures_again(tmp_path):
    (main, _, io), scope, exe, feed = _setup(staged=True)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    static.save_persistables(exe, str(tmp_path), main, scope=scope)
    name = main.all_parameters()[0].name
    scope.erase(name)  # the scope no longer holds it: a new tensor
    static.load_persistables(exe, str(tmp_path), main, scope=scope)
    phases = dict(exe.phases)
    exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    assert exe.phases["capture"] == phases["capture"] + 1


def test_loads_a_file_the_jax_package_wrote(tmp_path):
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_TINY, dtype="float32")
            jmain, jstartup, jio = jgpt.build_train_program(cfg, _B, _T)
            with jguard(jmain, jstartup):
                JAdam(learning_rate=1e-4).minimize(jio["loss"])
        jscope, jexe = JScope(), JExecutor()
        jexe.run(jstartup, scope=jscope)
        jstatic.save_persistables(jexe, str(tmp_path), jmain, scope=jscope)
        want = {v.name: np.asarray(jscope.get(v.name))
                for v in jmain.list_vars() if v.persistable}
    finally:
        pd.disable_static()
    (main, _, _), _, exe, _ = _setup()
    scope = Scope()
    static.load_persistables(exe, str(tmp_path), main, scope=scope)
    for n, arr in want.items():
        np.testing.assert_array_equal(scope.get(n).numpy(), arr)


def test_inference_model_io_is_not_ported(tmp_path):
    """(Named when the two raised; both are ported now.) The program
    pruned to the loss and the persistables it reads round-trip: loaded
    into a fresh scope, it gives the loss the saved state gives, bit for
    bit, and the pruned program holds no optimizer op."""
    (main, _, io), scope, exe, feed = _setup()
    saved = static.save_inference_model(
        str(tmp_path), ["tokens", "labels"], [io["loss"]], exe, main,
        scope=scope)
    assert saved == [io["loss"].name]
    want = exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)[0]
    fresh = Scope()
    prog, feeds, fetches = static.load_inference_model(str(tmp_path), exe,
                                                       scope=fresh)
    assert feeds == ["tokens", "labels"]
    assert "adam" not in [op.type for op in prog.global_block().ops]
    got = exe.run(prog, feed=feed, fetch_list=fetches, scope=fresh)[0]
    np.testing.assert_array_equal(got, want)


def test_resumed_epoch_loop_equals_uninterrupted_staged(tmp_path):
    program, scope, _, feed = _setup(staged=True)
    start = _state(program[0], scope)

    def exe_of():
        exe = Executor(CPUPlace())
        exe.staged = True
        return exe

    got = chip_smoke._recovery(torch, exe_of, program, start, feed,
                               str(tmp_path))
    assert got["bit_identical"]
    assert len(got["losses"]) == chip_smoke._EPOCHS * chip_smoke._EPOCH_STEPS
    assert "trajectory_continuation" in got["audit"]


def test_resume_gate_and_generator_form(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_RESTART_COUNT", raising=False)
    ckpt = str(tmp_path)
    assert list(ac.train_epoch_range(3, "g", checkpoint_dir=ckpt)) == [
        0, 1, 2]
    rng = ac.TrainEpochRange(3, "g", checkpoint_dir=ckpt)
    assert rng.restored_from() == 2
    # a fresh run sharing the directory does not skip its epochs...
    assert list(rng) == [0, 1, 2]
    # ...a relaunched one does
    monkeypatch.setenv("PADDLE_RESTART_COUNT", "1")
    assert list(ac.TrainEpochRange(5, "g", checkpoint_dir=ckpt)) == [3, 4]
