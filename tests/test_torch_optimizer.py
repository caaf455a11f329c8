"""The port's optimizers and executor, on the tiny GPT train program.

AdamW and SGD are held against the JAX package as the training test
holds Adam (``test_torch_static_training.py``): a 1-layer tiny GPT on
the materialized-logits loss path (the fused path is covered there),
the JAX startup values copied into the port with
``weights.scope_from_numpy``, 2 fp32 steps; loss at rtol 1e-4 and every
persistable at atol 1e-5 (the same fp32 arithmetic in another order).
The rest runs the port alone: ``state_dict``/``set_state_dict``, the
learning rate as a per-run feed, ``return_numpy=False``, the executor's
cache, span and counters, and the refusals of what is not ported.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest
import torch

import paddle_tpu as pd
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import errors, monitor, optimizer as topt, profiler
from paddle_tpu_torch.framework import CPUPlace, Executor, Scope
from paddle_tpu_torch.framework import program_guard, unique_name
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16, max_seq_len=8,
            fused_lm_head="off")
_B, _T = 2, 8
_OPTS = {"adamw": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05)),
         "sgd": ("SGD", dict(learning_rate=0.1))}


def _feed(seed=0):
    r = np.random.RandomState(seed)
    return {k: r.randint(0, 64, (_B, _T)).astype(np.int64)
            for k in ("tokens", "labels")}


def _torch_program(opt_cls="Adam", **kw):
    with unique_name.guard():
        main, startup, io = tgpt.build_train_program(
            tgpt.GPTConfig(**_CFG), _B, _T)
        opt = getattr(topt, opt_cls)(**(kw or dict(learning_rate=1e-3)))
        with program_guard(main, startup):
            opt.minimize(io["loss"])
    return main, startup, io, opt


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_two_fp32_steps_match_jax(opt):
    cls, kw = _OPTS[opt]
    feed = _feed()
    pd.enable_static()
    try:
        with jnames.guard():
            main, startup, io = jgpt.build_train_program(
                jgpt.GPTConfig(**_CFG), _B, _T)
            with jguard(main, startup):
                getattr(jopt, cls)(**kw).minimize(io["loss"])
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        jscope, jexe = JScope(), JExecutor()
        jexe.run(startup, scope=jscope)
        start = {n: np.asarray(jscope.get(n)) for n in names}
        jl = [float(jexe.run(main, feed=feed, fetch_list=[io["loss"]],
                             scope=jscope)[0]) for _ in range(2)]
        jend = {n: np.asarray(jscope.get(n)) for n in names}
    finally:
        pd.disable_static()
    tmain, _, tio, _ = _torch_program(cls, **kw)
    assert sorted(v.name for v in tmain.list_vars() if v.persistable) == names
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    tl = [float(exe.run(tmain, feed=feed, fetch_list=[tio["loss"]],
                        scope=scope)[0]) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(scope.get(n).numpy(), jend[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_state_dict_round_trip():
    main, startup, io, opt = _torch_program()
    scope, exe = Scope(), Executor(CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[io["loss"]], scope=scope)
    state = opt.state_dict(scope)
    assert {"gpt.wte_moment1_0", "gpt.wte_moment2_0", "gpt.wte_beta1_pow_0",
            "gpt.wte_beta2_pow_0"} <= set(state)
    assert state["gpt.wte_beta1_pow_0"].shape == (1,)
    assert np.abs(state["gpt.wte_moment1_0"]).max() > 0
    opt.set_state_dict({k: np.zeros_like(v) for k, v in state.items()},
                       scope)
    assert float(scope.get("gpt.wte_moment1_0").abs().max()) == 0.0
    opt.set_state_dict(state, scope)
    for k, v in state.items():
        np.testing.assert_array_equal(scope.get(k).numpy(), v)


def test_learning_rate_is_read_each_run():
    """The LR is an auto-feed: set_lr changes the next step, with no
    rebuild; at lr 0 Adam leaves every parameter where it was."""
    main, startup, io, opt = _torch_program("Adam", learning_rate=0.0)
    scope, exe = Scope(), Executor(CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.get("gpt.wte").clone()
    exe.run(main, feed=_feed(), fetch_list=[io["loss"]], scope=scope)
    assert torch.equal(scope.get("gpt.wte"), before)
    opt.set_lr(1e-2)
    exe.run(main, feed=_feed(), fetch_list=[io["loss"]], scope=scope)
    assert not torch.equal(scope.get("gpt.wte"), before)


def test_executor_run_is_observed_and_cached():
    main, startup, io, _ = _torch_program()
    scope, exe = Scope(), Executor(CPUPlace())
    exe.run(startup, scope=scope)

    def runs():
        fam = monitor.snapshot()["metrics"]["executor_run_total"]
        return sum(float(s["value"]) for s in fam["series"])

    before = runs()
    profiler.start_profiler()
    try:
        (loss,) = exe.run(main, feed=_feed(), fetch_list=[io["loss"]],
                          scope=scope, return_numpy=False)
        names = [e["name"] for e in profiler.get_events()]
    finally:
        profiler.stop_profiler(print_table=False)
        profiler.clear_events()
    assert isinstance(loss, torch.Tensor) and loss.shape == ()
    assert "executor/run" in names
    exe.run(main, feed=_feed(), fetch_list=[io["loss"]], scope=scope)
    assert runs() == before + 2
    assert len(exe._cache) == 2  # startup + main; the second run hit


def test_executor_refuses_what_is_not_ported(monkeypatch):
    main, startup, io, _ = _torch_program()
    exe = Executor(CPUPlace())
    with pytest.raises(errors.PreconditionNotMet, match="startup"):
        exe.run(main, feed=_feed(), fetch_list=[io["loss"]], scope=Scope())
    # A9's flags are ported: the numerics sentinel runs, it no longer
    # refuses
    with monkeypatch.context() as m:
        m.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
        scope = Scope()
        exe.run(startup, scope=scope)
        assert scope.has(main.all_parameters()[0].name)
    main._pipeline_meta = object()
    with pytest.raises(errors.Unimplemented, match="A10"):
        exe.run(main, scope=Scope())
    # grad_clip and weight_decay, refused until they were ported, now
    # append their ops (held against the JAX package in
    # tests/test_torch_clip_optimizers.py)
    main, startup, io, _ = _torch_program(
        "SGD", learning_rate=0.1, weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(1.0))
    types = [op.type for op in main.global_block().ops]
    assert {"squared_l2_norm", "sqrt", "elementwise_max", "elementwise_div",
            "elementwise_mul", "scale"} <= set(types)
    # the dygraph step, refused until the eager API was ported, now runs
    # (tests/test_torch_dygraph.py); without parameters it says so
    with pytest.raises(ValueError, match="parameters"):
        topt.Adam().step()
