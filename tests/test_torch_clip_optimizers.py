"""Gradient clipping, weight-decay regularizers and the eight remaining
optimizers of the port, against the JAX package.

One small classifier program (x [6, 8] fed; fc 8 -> 16, gelu, fc 16 -> 4;
softmax cross-entropy against fed labels; mean), built in both packages
under ``unique_name.guard()`` with the same minimize call, so both
programs have the same ops and the same variable names (accumulators
included: ``<param>_<name>_<k>``). The JAX startup values go into the
port's scope as numpy (``weights.scope_from_numpy``); both run 3 steps on
the same batch. A classifier rather than the GPT: its gradients are well
away from zero, so the rules that divide by a gradient's own size
(Adagrad, RMSProp, Adadelta, Lamb, LARS) do not turn the two packages'
rounding noise into whole steps.

Tolerances: fp32, every loss and every persistable (parameters and every
accumulator) at rtol 1e-5, atol 1e-6 (the same fp32 arithmetic in another
order). One bf16 case (AdamW with a global-norm clip) is held to the
reference's own dtype rule: each clip op's output dtype is the JAX
program's (the norm and its sum bf16, the scale and the clipped gradients
fp32), and the values at rtol 2e-2 (bf16 rounds at other places in the
two frameworks).
"""
import numpy as np
import pytest

import paddle_tpu as pd
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.regularizer as jreg
from paddle_tpu import framework as jfw
from paddle_tpu.static import nn as jsnn

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.regularizer as treg
from paddle_tpu_torch import framework as tfw
from paddle_tpu_torch.static import nn as tsnn
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_N, _D, _H, _C = 6, 8, 16, 4


class _Pkg:
    def __init__(self, fw, snn, opt, nn, reg):
        self.fw, self.snn, self.opt, self.nn, self.reg = fw, snn, opt, nn, reg


_JAX = _Pkg(jfw, jsnn, jopt, jnn, jreg)
_TORCH = _Pkg(tfw, tsnn, topt, tnn, treg)

# name -> (optimizer class, kwargs, {param: ParamAttr kwargs}); kwargs
# values that are callables get the package (for clip classes and
# regularizers)
_CASES = {
    "clip_by_value": ("SGD", dict(
        learning_rate=0.1,
        grad_clip=lambda k: k.nn.ClipGradByValue(0.02)), {}),
    "clip_by_norm": ("SGD", dict(
        learning_rate=0.1, grad_clip=lambda k: k.nn.ClipGradByNorm(0.05)),
        {}),
    "clip_by_global_norm": ("SGD", dict(
        learning_rate=0.1,
        grad_clip=lambda k: k.nn.ClipGradByGlobalNorm(0.05)),
        {"fc2.b": dict(need_clip=False)}),
    "l2_decay": ("SGD", dict(learning_rate=0.1, weight_decay=0.1), {}),
    "l1_decay": ("SGD", dict(learning_rate=0.1,
                             weight_decay=lambda k: k.reg.L1Decay(0.05)), {}),
    "per_param_decay": ("SGD", dict(learning_rate=0.1, weight_decay=0.1), {
        "fc1.w": dict(regularizer=lambda k: k.reg.L1Decay(0.05)),
        "fc2.w": dict(regularizer=lambda k: k.reg.L2Decay(0.3))}),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9), {}),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True), {}),
    "adagrad": ("Adagrad", dict(learning_rate=0.05), {}),
    "adamax": ("Adamax", dict(learning_rate=0.01), {}),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01), {}),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True), {}),
    "adadelta": ("Adadelta", dict(learning_rate=1.0), {}),
    "lamb": ("Lamb", dict(learning_rate=0.01), {}),
    "lars_momentum": ("LarsMomentum", dict(learning_rate=0.5), {}),
    "dgc_momentum": ("DGCMomentumOptimizer", dict(
        learning_rate=0.1, momentum=0.9, rampup_begin_step=1,
        sparsity=[0.5]), {}),
    "adamw_global_norm": ("AdamW", dict(
        learning_rate=1e-2, weight_decay=0.01,
        grad_clip=lambda k: k.nn.ClipGradByGlobalNorm(0.05)), {}),
}


def _resolve(v, k):
    return v(k) if callable(v) else v


def _build(k, case, dtype="float32"):
    cls, kw, attrs = _CASES[case]
    with k.fw.unique_name.guard():
        main, startup = k.fw.Program(), k.fw.Program()
        with k.fw.program_guard(main, startup):
            x = k.snn.data("x", [_N, _D], dtype)
            lbl = k.snn.data("label", [_N, 1], "int64")
            helper = k.fw.LayerHelper("mlp")

            def param(name, shape, std):
                extra = {a: _resolve(v, k)
                         for a, v in attrs.get(name, {}).items()}
                init = (k.fw.initializer.ConstantInitializer(0.01)
                        if name.endswith(".b") else
                        k.fw.initializer.NormalInitializer(0.0, std))
                return helper.create_parameter(
                    k.fw.ParamAttr(name=name, initializer=init, **extra),
                    shape=shape, dtype=dtype)

            h = k.snn.gelu(k.snn.elementwise_add(
                k.snn.matmul(x, param("fc1.w", [_D, _H], 0.5)),
                param("fc1.b", [_H], 0)))
            logits = k.snn.elementwise_add(
                k.snn.matmul(h, param("fc2.w", [_H, _C], 0.5)),
                param("fc2.b", [_C], 0))
            loss = k.snn.mean(k.snn.softmax_with_cross_entropy(logits, lbl))
            opt = getattr(k.opt, cls)(**{a: _resolve(v, k)
                                         for a, v in kw.items()})
            opt.minimize(loss)
    main._test_optimizer = opt
    return main, startup, loss


def _feed(dtype="float32"):
    r = np.random.RandomState(0)
    x = r.randn(_N, _D).astype(np.float32)
    return {"x": x, "label": r.randint(0, _C, (_N, 1)).astype(np.int64)}


def _jax_steps(case, dtype, steps=3):
    pd.enable_static()
    try:
        main, startup, loss = _build(_JAX, case, dtype)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope, exe = jfw.Scope(), jfw.Executor()
        exe.run(startup, scope=scope)
        start = {n: np.asarray(scope.get(n)) for n in names}
        feed = _feed()
        if dtype == "bfloat16":
            import jax.numpy as jnp

            feed["x"] = jnp.asarray(feed["x"], jnp.bfloat16)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(steps)]
        end = {n: np.asarray(scope.get(n), np.float32) for n in names}
        dtypes = {v.name: str(v.dtype) for v in main.list_vars()}
        return losses, start, end, dtypes, main
    finally:
        pd.disable_static()


def _torch_steps(case, dtype, start, steps=3, staged=False):
    import torch

    main, startup, loss = _build(_TORCH, case, dtype)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    assert names == sorted(start)
    scope = scope_from_numpy(start, tfw.Scope(), "cpu")
    exe = tfw.Executor(tfw.CPUPlace())
    exe.staged = staged
    feed = _feed()
    feed["x"] = torch.from_numpy(feed["x"]).to(getattr(torch, dtype))
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    end = {n: scope.get(n).float().numpy() for n in names}
    return losses, end, main, exe


@pytest.mark.parametrize("case", sorted(_CASES))
def test_update_rule_matches_jax(case):
    jl, start, jend, _, jmain = _jax_steps(case, "float32")
    tl, tend, tmain, _ = _torch_steps(case, "float32", start)
    assert ([op.type for op in tmain.global_block().ops]
            == [op.type for op in jmain.global_block().ops])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    moved = [n for n in jend if not np.array_equal(jend[n], start[n])]
    assert {"fc1.w", "fc2.w"} <= set(moved)
    # every rule survives the staged route: 3 staged steps = 3 eager
    sl, send, _, exe = _torch_steps(case, "float32", start, staged=True)
    assert exe.phases == {"eager": 1, "capture": 1, "replay": 1}
    assert sl == tl
    for name in tend:
        np.testing.assert_array_equal(send[name], tend[name], err_msg=name)


def test_bf16_global_norm_clip_keeps_the_reference_dtypes():
    import torch

    case = "adamw_global_norm"
    jl, start, jend, jdtypes, jmain = _jax_steps(case, "bfloat16")
    tl, tend, tmain, _ = _torch_steps(case, "bfloat16", start)
    clip_ops = ("squared_l2_norm", "sum", "sqrt", "elementwise_max",
                "elementwise_div", "elementwise_mul")
    seen = {}
    for op in tmain.global_block().ops:
        if op.type in clip_ops:
            var = tmain.global_block().var(op.output("Out")[0])
            seen.setdefault(op.type, set()).add(
                tfw.core.dtype_name(var.dtype))
            assert jdtypes[var.name] == tfw.core.dtype_name(var.dtype), (
                op.type, var.name)
    assert seen == {"squared_l2_norm": {"bfloat16"}, "sum": {"bfloat16"},
                    "sqrt": {"bfloat16"}, "elementwise_max": {"float32"},
                    "elementwise_div": {"float32"},
                    "elementwise_mul": {"float32"}}
    assert tmain.global_block().var("fc1.w").dtype == torch.bfloat16
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name], rtol=2e-2,
                                   atol=2e-2, err_msg=name)


def test_accumulators_round_trip_through_state_dict():
    """The accumulators carry the JAX package's names, and the port's
    ``state_dict``/``set_state_dict`` carry them into another scope."""
    import torch

    main, startup, loss = _build(_TORCH, "rmsprop_centered")
    opt = main._test_optimizer
    scope, exe = tfw.Scope(), tfw.Executor(tfw.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    state = opt.state_dict(scope)
    assert sorted(state) == sorted(
        f"{p}_{acc}_0" for p in ("fc1.b", "fc1.w", "fc2.b", "fc2.w")
        for acc in ("mean_square", "momentum_acc", "mean_grad"))
    assert any(np.abs(v).max() > 0 for v in state.values())
    other = tfw.Scope()
    for n, v in state.items():
        other.set(n, torch.zeros(v.shape))
    opt.set_state_dict(state, scope=other)
    for n, v in state.items():
        np.testing.assert_array_equal(other.get(n).numpy(), v)


def test_dgc_keeps_a_bf16_parameter_bf16():
    """A kept difference: the JAX rule of ``dgc_momentum`` returns a bf16
    parameter promoted to fp32 (the sparse gradient is fp32), which its
    executor stores; the port returns each output in its persistable's
    dtype, so an eager step and a replayed one (which writes in place)
    agree and the parameter stays bf16."""
    import torch

    _, start, _, _, _ = _jax_steps("dgc_momentum", "bfloat16", steps=1)
    eager = _torch_steps("dgc_momentum", "bfloat16", start)
    staged = _torch_steps("dgc_momentum", "bfloat16", start, staged=True)
    assert staged[0] == eager[0] and np.isfinite(eager[0]).all()
    for name in eager[1]:
        np.testing.assert_array_equal(staged[1][name], eager[1][name])
    for p in eager[2].all_parameters():  # bf16 values, not fp32 ones
        got = torch.from_numpy(eager[1][p.name])
        assert torch.equal(got.bfloat16().float(), got), p.name
