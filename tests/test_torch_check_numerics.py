"""The numerics sentinel (``PADDLE_TPU_CHECK_NUMERICS=1``) and
``FLAGS_check_nan_inf`` on the port's executor, against the JAX
package's.

The tiny GPT train program is built in both packages from the same
startup values (the JAX package's, copied into the port); one ``inf`` is
written into a persistable, and one step runs with the sentinel on. Both
packages must name the same op (index and type) and the same output
variable, the port on its eager route and on ``Executor.staged`` (the
compiled route on the CPU: the probes write their device vector inside
the captured body, read back after the run), as the JAX package's
``tests/test_check_numerics.py`` asks: a typed ``InvalidArgument`` with
the op's provenance, catchable as ``EnforceError``, counted on
``executor_nonfinite_total``; the legacy flag raises
``FloatingPointError`` with the same op. The probes read and never
write: the losses and every persistable with the sentinel on equal those
with it off, bit for bit, on both routes. Either flag is part of the
cache key, and with both off nothing is probed.
"""
import re

import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu import flags as jflags
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import errors as jerrors
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.framework import CPUPlace, Executor, Scope, errors
from paddle_tpu_torch.weights import scope_from_numpy
from test_torch_replay import _CFG, _B, _batch, _program
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_MSG = re.compile(r"op #(\d+) '([^']+)' produced [^']+ in output '([^']+)'")
# persistables to poison at [0, 0] (a vector at [0])
_POISON = ["gpt.wte", "gpt.wpe", "gpt.h0.ln1.scale", "gpt.h0.attn.q.w",
           "gpt.h1.mlp.fc_out.w", "gpt.lnf.bias"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CHECK_NUMERICS", raising=False)
    monitor.enable(True)
    yield
    flags.set_flags({"FLAGS_check_nan_inf": False})
    jflags.set_flags({"FLAGS_check_nan_inf": False})


def _poison(arr, name):
    arr = np.array(arr, copy=True)
    arr[(0,) * arr.ndim] = np.inf
    return arr


def _named(err):
    m = _MSG.search(str(err))
    assert m, str(err)
    return int(m.group(1)), m.group(2), m.group(3)


def _jax_step(feed, poison=None):
    """(start, loss or the error): the JAX package's program, one step
    from its own startup values, ``poison`` poisoned."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, dtype="float32")
            main, startup, io = jgpt.build_train_program(
                cfg, _B, _CFG["max_seq_len"])
            with jguard(main, startup):
                JAdam(learning_rate=1e-3).minimize(io["loss"])
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
        start = {n: np.asarray(scope.get(n)) for n in names}
        if poison is not None:
            import jax.numpy as jnp

            scope.set(poison, jnp.asarray(_poison(start[poison], poison)))
        try:
            return start, exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                  scope=scope)[0]
        except (jerrors.EnforceError, FloatingPointError) as e:
            return start, e
    finally:
        pd.disable_static()


@pytest.fixture(scope="module")
def start():
    return _jax_step(_batch(_CFG))[0]


def _port_step(start, feed, staged, poison=None, steps=1):
    main, _, io, _ = _program()
    values = dict(start)
    scope = scope_from_numpy(values, Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = staged
    for i in range(steps):
        if poison is not None and i == steps - 1:
            t = scope.get(poison)
            t.view(-1)[0] = float("inf")
        try:
            exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
        except (errors.EnforceError, FloatingPointError) as e:
            return main, e
    return main, None


def _nonfinite_total():
    fam = monitor.snapshot()["metrics"].get("executor_nonfinite_total", {})
    return sum(s["value"] for s in fam.get("series", []))


@pytest.mark.parametrize("name", _POISON)
def test_sentinel_names_the_same_op_as_the_reference(name, start,
                                                     monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    feed = _batch(_CFG)
    _, jerr = _jax_step(feed, poison=name)
    assert isinstance(jerr, jerrors.InvalidArgumentError)
    want = _named(jerr)
    before = _nonfinite_total()
    for staged in (False, True):
        # staged: the warm-up and the capture run clean, the replay
        # poisoned
        main, err = _port_step(start, feed, staged, poison=name,
                               steps=3 if staged else 1)
        assert isinstance(err, errors.InvalidArgumentError), err
        assert isinstance(err, errors.EnforceError)
        assert _named(err) == want, (staged, str(err))
        idx, op_type, _ = want
        prov = err.op_provenance
        assert (prov.op_idx, prov.op_type, prov.block_idx) == (idx, op_type,
                                                              0)
        assert prov.callstack  # the Python line that built the op
        # nothing before it held a non-finite value: it reads the poison
        assert name in main.global_block().ops[idx].input_arg_names()
    assert _nonfinite_total() == before + 2


def test_legacy_flag_raises_floating_point_error_alike(start):
    feed = _batch(_CFG)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    jflags.set_flags({"FLAGS_check_nan_inf": True})
    assert flags.get_flags("FLAGS_check_nan_inf") is True
    assert flags.get_flags(["check_nan_inf"]) == {"check_nan_inf": True}
    _, jerr = _jax_step(feed, poison="gpt.h0.attn.q.w")
    assert isinstance(jerr, FloatingPointError)
    for staged in (False, True):
        _, err = _port_step(start, feed, staged, poison="gpt.h0.attn.q.w",
                            steps=3 if staged else 1)
        assert type(err) is FloatingPointError
        assert str(err).startswith("FLAGS_check_nan_inf: ")
        assert _named(err) == _named(jerr)
    with pytest.raises(KeyError):
        flags.set_flags({"FLAGS_no_such_flag": 1})


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_sentinel_changes_no_value(staged, start, monkeypatch):
    """Losses and every persistable after 4 steps, sentinel on and off,
    bit for bit."""
    feed = _batch(_CFG)
    runs = []
    for on in (False, True):
        if on:
            monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
        main, _, io, _ = _program()
        scope = scope_from_numpy(dict(start), Scope(), "cpu")
        exe = Executor(CPUPlace())
        exe.staged = staged
        losses = [exe.run(main, feed=feed, fetch_list=[io["loss"]],
                          scope=scope)[0] for _ in range(4)]
        probes = [e.probes for e in exe._cache.values()]
        assert all((p is not None) == on for p in probes)
        runs.append((losses, {n: scope.get(n).numpy() for n in start}))
    assert [float(x) for x in runs[0][0]] == [float(x) for x in runs[1][0]]
    for n in start:
        assert np.array_equal(runs[0][1][n], runs[1][1][n]), n


def test_sentinel_is_part_of_the_cache_key(start, monkeypatch):
    feed = _batch(_CFG)
    main, _, io, _ = _program()
    scope = scope_from_numpy(dict(start), Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    scope.get("gpt.wte").view(-1)[0] = float("inf")
    # off: the nan flows through, nothing raises
    loss = exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    assert not np.isfinite(loss[0])
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    with pytest.raises(errors.InvalidArgumentError, match="lookup_table"):
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    assert len(exe._cache) == 2


def test_probe_sites_are_every_float_output(start, monkeypatch):
    """The entry's first run lists a site for each float output of each
    non-structural op, in program order; the flags vector has one slot a
    site."""
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    feed = _batch(_CFG)
    main, _, io, _ = _program()
    scope = scope_from_numpy(dict(start), Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = True
    exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    (entry,) = exe._cache.values()
    sites = entry.probes.sites
    assert sum(len(v) for v in entry.probes.maxabs.values()) == len(sites)
    assert [s[0] for s in sites] == sorted(s[0] for s in sites)
    block = main.global_block()
    for idx, op_type, var in sites:
        assert block.ops[idx].type == op_type
        assert var in block.ops[idx].output_arg_names()
    assert {s[1] for s in sites} >= {"lookup_table_v2", "matmul", "adam",
                                     "layer_norm", "fused_lm_head_ce"}


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_bf16_probes_name_the_reader(staged, monkeypatch):
    """A bf16 program's probes (slots in bf16 and fp32 vectors) name the
    op that reads a poisoned weight, and stay quiet on a clean step."""
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    cfg = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16,
               max_seq_len=32, dtype="bfloat16")
    main, startup, io = chip_smoke._train_program(cfg, 2, 8)
    scope, exe = Scope(), Executor(CPUPlace())
    exe.staged = staged
    exe.run(startup, scope=scope)
    feed = chip_smoke._fixed_batch(torch, 64, 2, 8, "cpu")
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    (entry,) = [e for e in exe._cache.values() if e.fetch_names
                == (io["loss"].name,)]
    assert {torch.bfloat16, torch.float32} <= set(entry.probes.maxabs)
    scope.get("gpt.h0.attn.q.w").view(-1)[0] = float("inf")
    with pytest.raises(errors.InvalidArgumentError) as info:
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
    idx, op_type, _ = _named(info.value)
    assert op_type == "matmul"
    assert "gpt.h0.attn.q.w" in main.global_block().ops[idx].input_arg_names()
