"""The port's static mixed precision (``static/amp.py``) against the JAX
package's.

The rewrite: on the same fp32 program (``fc`` -> ``mean``) both packages
insert the same casts, but only the port's white-list op reads them. The
JAX package compares lists of Variables with ``!=``, which with its
``Variable`` overloads appends an ``equal`` op and answers "equal", so its
``mul`` keeps reading the fp32 inputs and two ``equal`` ops sit in its
program (a difference kept on purpose, ``ROADMAP.md``).

Training: a tiny GPT (2 layers, 2 heads, d 32, vocab 128, seq 16, batch
2) built in fp32 and decorated (``decorate(Adam(1e-3))``, bf16, dynamic
scaling from 2^15) in both packages, from the JAX package's start values
(``weights.scope_from_numpy``, the ``@AMP`` persistables included): the
port computes its matmuls and attention in bf16, the JAX package in fp32
(its rewrite is dead), so the losses are held at 2e-2 relative, the
bound of ``tests/test_static_amp.py``; decorated SGD, whose update is the
gradient it is handed (a scale left on it shows as 2^15), takes each
parameter the reference's step. The port's step replayed (the
staged route on the CPU) equals its eager step bit for bit. An overflow
step (an inf in a weight, ``decr_every_n_nan_or_inf=1``) leaves every
parameter and accumulator unchanged and halves the scale, in both
packages. ``decorate`` over a clipped optimizer trains.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as pd
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.framework import CPUPlace, Executor, Scope  # noqa: E402
from paddle_tpu_torch.framework import program_guard, unique_name  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.weights import scope_from_numpy  # noqa: E402
from torch_modes import static_mode  # noqa: F401,E402 (autouse fixture)

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)
_B = 2
_AMP = ("@AMP.loss_scaling", "@AMP.good_steps", "@AMP.bad_steps")
_SGD_LR = 0.5
_SGD_UPDATE_RTOL = 5e-2


def _feed(seed=0):
    r = np.random.RandomState(seed)
    shape = (_B, _CFG["max_seq_len"])
    return {"tokens": r.randint(0, 128, shape).astype(np.int64),
            "labels": r.randint(0, 128, shape).astype(np.int64)}


def _fc_mean(pkg, guard, names):
    """x -> fc -> mean, decorated SGD; returns the main program."""
    main, startup = pkg.static.Program(), pkg.static.Program()
    with names.guard(), guard(main, startup):
        x = pkg.static.data("x", [4, 8], "float32")
        y = pkg.static.nn.fc(x, 3, name="fca")
        loss = pkg.static.nn.mean(y)
        pkg.static.amp.decorate(pkg.optimizer.SGD(0.1)).minimize(loss)
    return main


def test_rewrite_inserts_the_references_casts_and_wires_them():
    pd.enable_static()
    try:
        jmain = _fc_mean(pd, jguard, jnames)
    finally:
        pd.disable_static()
    tmain = _fc_mean(pt, program_guard, unique_name)
    jops = [op for op in jmain.global_block().ops]
    tops = [op for op in tmain.global_block().ops]
    jcount, tcount = Counter(o.type for o in jops), Counter(o.type
                                                           for o in tops)
    assert tcount["cast"] == jcount["cast"] == 2
    jmul = next(o for o in jops if o.type == "mul")
    tmul = next(o for o in tops if o.type == "mul")
    # the reference's mul reads the uncast inputs, and its != on lists of
    # Variables left two equal ops; the port's mul reads the casts
    assert jmul.input("X") == ["x"] and jmul.input("Y") == ["fca.w_0"]
    assert jcount["equal"] == 2
    assert tmul.input("X")[0].startswith("x.cast_bf16")
    assert tmul.input("Y")[0].startswith("fca.w_0.cast_bf16")
    assert "equal" not in tcount
    assert all(str(v.dtype) == "torch.bfloat16"
               for vs in tmul._input_vars.values() for v in vs)


def _optimizer(pkg, name, clip):
    if name == "sgd":
        return pkg.optimizer.SGD(learning_rate=_SGD_LR, grad_clip=clip)
    return pkg.optimizer.Adam(learning_rate=1e-3, grad_clip=clip)


def _jax_decorated(steps, feed, poison=None, optimizer="adam", **amp_kw):
    """(start values, losses, values after the steps) of the reference."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, dtype="float32")
            main, startup, io = jgpt.build_train_program(
                cfg, _B, _CFG["max_seq_len"])
            with jguard(main, startup):
                opt = _optimizer(pd, optimizer, amp_kw.pop("clip", None))
                pd.static.amp.decorate(opt, **amp_kw).minimize(io["loss"])
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
        if poison:
            w = np.array(scope.get(poison))
            w.reshape(-1)[0] = np.inf
            scope.set(poison, w)
        start = {n: np.asarray(scope.get(n)) for n in names}
        losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                scope=scope)[0]) for _ in range(steps)]
        return start, losses, {n: np.asarray(scope.get(n)) for n in names}
    finally:
        pd.disable_static()


def _port_decorated(start, steps, feed, staged=False, optimizer="adam",
                    **amp_kw):
    """(losses, values after the steps, main program) of the port from
    the reference's start values."""
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**_CFG, dtype="float32")
        main, startup, io = tgpt.build_train_program(
            cfg, _B, _CFG["max_seq_len"])
        with program_guard(main, startup):
            opt = _optimizer(pt, optimizer, amp_kw.pop("clip", None))
            pt.static.amp.decorate(opt, **amp_kw).minimize(io["loss"])
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = staged
    losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                            scope=scope)[0]) for _ in range(steps)]
    after = {n: scope.get(n).numpy() for n in start}
    return losses, after, main


def test_decorated_gpt_trains_within_2e_2_of_the_reference():
    feed = _feed()
    start, jl, jafter = _jax_decorated(3, feed)
    assert start["@AMP.loss_scaling"].tolist() == [2.0 ** 15]
    tl, tafter, main = _port_decorated(start, 3, feed)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]
    types = Counter(op.type for op in main.global_block().ops)
    assert types["cast"] > 0 and "equal" not in types
    for op in main.global_block().ops:
        if op.type in ("matmul", "fused_attention_tpu"):
            assert all(str(v.dtype) == "torch.bfloat16"
                       for vs in op._input_vars.values() for v in vs)
    # the scale's persistables moved as the reference's did (3 good steps,
    # int32 counts), and the parameters stayed fp32
    for n in _AMP:
        np.testing.assert_array_equal(tafter[n], jafter[n])
        assert tafter[n].dtype == jafter[n].dtype, n
    assert tafter["@AMP.good_steps"].dtype == np.int32
    params = [p.name for p in main.all_parameters()]
    assert params and all(tafter[n].dtype == np.float32 for n in params)


def test_decorated_sgd_takes_the_references_unscaled_step():
    """SGD's update is lr times the gradient it is handed, so a gradient
    left scaled by 2^15, or unscaled twice, moves each parameter 2^15
    times too far or too little; Adam's barely shows it. The port's
    decorated step (bf16 compute) against the reference's (fp32 compute,
    its rewrite dead), each parameter's update by the norm of the
    difference over the reference's (``chip_smoke._leaves_agree``, as the
    card's ``static_amp`` holds Adam's first moments): at most
    ``_SGD_UPDATE_RTOL`` at the worst parameter, two steps from one
    start. Sound, the worst reads 6.2e-3 (``gpt.h0.attn.k.w``)."""
    feed = _feed(5)
    start, jl, jafter = _jax_decorated(2, feed, optimizer="sgd")
    tl, tafter, main = _port_decorated(start, 2, feed, optimizer="sgd")
    np.testing.assert_allclose(tl, jl, rtol=2e-2)

    def updates(after):
        return {p.name: torch.from_numpy(after[p.name].astype(np.float64)
                                         - start[p.name])
                for p in main.all_parameters()}

    got = chip_smoke._leaves_agree(updates(tafter), updates(jafter),
                                   _SGD_UPDATE_RTOL, "decorated SGD update")
    assert got["leaves"] == len(main.all_parameters()) > 20


def test_scope_from_numpy_carries_the_amp_persistables():
    """After a step the reference's good/bad counts are int32: they come
    across with their dtype, and the port continues from them."""
    feed = _feed(1)
    _, _, after_one = _jax_decorated(1, feed)
    assert after_one["@AMP.good_steps"].dtype == np.int32
    scope = scope_from_numpy({n: after_one[n] for n in _AMP}, Scope(), "cpu")
    assert str(scope.get("@AMP.good_steps").dtype) == "torch.int32"
    _, jl, jafter = _jax_decorated(2, feed)
    tl, tafter, _ = _port_decorated(after_one, 1, feed)
    np.testing.assert_allclose(tl, jl[1:], rtol=2e-2)
    for n in _AMP:
        np.testing.assert_array_equal(tafter[n], jafter[n])


def test_replayed_decorated_steps_equal_eager_steps():
    feed = _feed(2)
    start, _, _ = _jax_decorated(0, feed)
    el, eafter, _ = _port_decorated(start, 3, feed)
    rl, rafter, _ = _port_decorated(start, 3, feed, staged=True)
    assert el == rl
    for n in eafter:
        np.testing.assert_array_equal(rafter[n], eafter[n], err_msg=n)


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "replayed"])
def test_overflow_step_skips_the_update_and_halves_the_scale(staged):
    feed = _feed(3)
    poison = "gpt.h0.attn.q.w"
    start, jl, jafter = _jax_decorated(1, feed, poison=poison,
                                       decr_every_n_nan_or_inf=1)
    tl, tafter, _ = _port_decorated(start, 1, feed, staged=staged,
                                    decr_every_n_nan_or_inf=1)
    assert not np.isfinite(jl[0]) and not np.isfinite(tl[0])
    for after in (jafter, tafter):
        assert after["@AMP.loss_scaling"].tolist() == [2.0 ** 14]
        assert after["@AMP.bad_steps"].tolist() == [0]
        assert after["@AMP.good_steps"].tolist() == [0]
        for n, v in start.items():
            if not n.startswith("@AMP"):
                np.testing.assert_array_equal(after[n], v, err_msg=n)


def test_decorate_over_a_clipped_optimizer_trains():
    feed = _feed(4)
    start, jl, _ = _jax_decorated(
        3, feed, clip=pd.nn.ClipGradByGlobalNorm(1.0))
    tl, _, main = _port_decorated(
        start, 3, feed, clip=pt.nn.ClipGradByGlobalNorm(1.0))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    assert "squared_l2_norm" in {op.type for op in main.global_block().ops}
