"""The GPT pretraining recipe's framework pieces, against the JAX package
and on the port alone: recompute, the device's random stream, liveness,
the chunked lm-head CE and set_device/get_device.

- Recompute (``RecomputeOptimizer``, ``append_backward_with_checkpoints``)
  on the tiny GPT of ``tests/test_recompute.py`` (vocab 64, 3 layers, 2
  heads, d 32, seq 16, batch 4, SGD at 0.1): the program's op list equals
  the JAX package's op for op (types, inputs, outputs, attrs: the clones,
  the ``recompute_barrier``s and the renamed outputs); 3 steps equal the
  plain backward's bit for bit on the port, at dropout 0 and 0.5, eager
  and staged; and match the JAX package's recompute at dropout 0 from the
  same numpy start (losses rtol 1e-5, the JAX package's own bound in
  ``tests/test_recompute.py``; parameters atol 1e-6).
- The random stream (``registry.draw_bits``, the executor's (seed, step)
  tensor) on the CPU through ``Executor.staged``: staged equals eager bit
  for bit, draws differ across steps, a recomputed clone redraws its
  forward's mask, a fixed ``seed`` attribute stays fixed; the hash's bits
  on a tensor equal those from Python ints (no overflow, no sign).
- Liveness: an intermediate is freed (its weakref dies) before the step
  ends, while fetches, feeds and persistables survive.
- The chunked CE: loss, dx and dW against the JAX package's
  ``impl="chunked"`` (its custom VJP) with N not a multiple of the chunk,
  fp32 at rtol 1e-5 and bf16 at rtol 2e-2.
- set_device/get_device, and no card plus the default place raising.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as pd
from paddle_tpu.distributed.fleet.meta_optimizers import (
    RecomputeOptimizer as JRecompute)
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import SGD as JSGD

import paddle_tpu_torch
from paddle_tpu_torch import errors
from paddle_tpu_torch.distributed.fleet import RecomputeOptimizer
from paddle_tpu_torch.framework import (CPUPlace, CUDAPlace, Executor,
                                        Program, Scope, UniformInitializer,
                                        core, program_guard, registry,
                                        unique_name)
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=64, n_layer=3, n_head=2, d_model=32, max_seq_len=16)
_B, _T = 4, 16


def _feed():
    r = np.random.RandomState(0)
    return {k: r.randint(0, 64, (_B, _T)).astype("int64")
            for k in ("tokens", "labels")}


def _torch_program(recompute, dropout=0.0, cfg=_CFG):
    with unique_name.guard():
        main, startup, io = tgpt.build_train_program(
            tgpt.GPTConfig(**cfg, dropout=dropout), _B, _T)
        main.random_seed = 7
        with program_guard(main, startup):
            opt = SGD(learning_rate=0.1)
            if recompute:
                opt = RecomputeOptimizer(opt, {"checkpoints": [
                    v.name for v in io["checkpoints"]]})
            opt.minimize(io["loss"])
    return main, startup, io


def _jax_program(recompute):
    with jnames.guard():
        main, startup, io = jgpt.build_train_program(
            jgpt.GPTConfig(**_CFG), _B, _T)
        main.random_seed = 7
        with jguard(main, startup):
            opt = JSGD(learning_rate=0.1)
            if recompute:
                opt = JRecompute(opt, {"checkpoints": [
                    v.name for v in io["checkpoints"]]})
            opt.minimize(io["loss"])
    return main, startup, io


def _ops(program):
    return [(op.type,
             sorted((slot, tuple(op.input(slot))) for slot in op.input_names),
             sorted((slot, tuple(op.output(slot)))
                    for slot in op.output_names),
             {k: v for k, v in op.all_attrs().items()
              if k not in ("op_callstack", "op_device")})
            for op in program.global_block().ops]


def _torch_steps(program, start, steps=3, staged=False, fetch=()):
    main, _, io = program
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    exe.staged = staged
    feed = _feed()
    losses, fetched = [], []
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[io["loss"], *fetch],
                      scope=scope)
        losses.append(float(out[0]))
        fetched.append(out[1:])
    state = {n: scope.get(n).float().numpy() for n in start}
    return losses, state, fetched, exe


def _start(program):
    main, startup, _ = program
    scope, exe = Scope(), Executor(CPUPlace())
    exe.run(startup, scope=scope)
    return {v.name: scope.get(v.name).numpy() for v in main.list_vars()
            if v.persistable}


def test_recompute_op_list_equals_the_jax_package():
    pd.enable_static()
    try:
        jmain, _, _ = _jax_program(True)
    finally:
        pd.disable_static()
    tmain, _, _ = _torch_program(True)
    jops, tops = _ops(jmain), _ops(tmain)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for t, j in zip(tops, jops):
        assert t[1:3] == j[1:3], (t[0], t[1:3], j[1:3])
        assert set(t[3]) == set(j[3]), t[0]
    types = [o[0] for o in tops]
    assert types.count("fused_attention_tpu") == 2 * _CFG["n_layer"]
    assert types.count("recompute_barrier") > _CFG["n_layer"]
    assert any("@RECOMPUTE" in n for o in tops for _, a in o[2] for n in a)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_recompute_equals_the_plain_backward(dropout):
    plain = _torch_program(False, dropout)
    start = _start(plain)
    want = _torch_steps(plain, start)
    for staged in (False, True):
        got = _torch_steps(_torch_program(True, dropout), start,
                           staged=staged)
        assert got[0] == want[0]
        for name in start:
            np.testing.assert_array_equal(got[1][name], want[1][name],
                                          err_msg=name)
    assert want[0][-1] < want[0][0]


def test_recompute_matches_the_jax_package_recompute():
    pd.enable_static()
    try:
        jmain, jstartup, jio = _jax_program(True)
        names = sorted(v.name for v in jmain.list_vars() if v.persistable)
        scope, exe = JScope(), JExecutor()
        exe.run(jstartup, scope=scope)
        start = {n: np.asarray(scope.get(n)) for n in names}
        feed = _feed()
        jl = [float(exe.run(jmain, feed=feed, fetch_list=[jio["loss"]],
                            scope=scope)[0]) for _ in range(3)]
        jend = {n: np.asarray(scope.get(n)) for n in names}
    finally:
        pd.disable_static()
    tl, tend, _, _ = _torch_steps(_torch_program(True), start)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tend[n], jend[n], atol=1e-6, rtol=0,
                                   err_msg=n)


def test_grad_ops_take_the_clones_records():
    """Only the clones are taped: the original forward ops of a
    recomputed segment run off the tape, and only a checkpoint's own op
    (no clone) has its grad op rerun the forward rule."""
    main, startup, io = _torch_program(True, 0.5)
    _, _, _, exe = _torch_steps((main, startup, io), _start(
        (main, startup, io)), steps=1)
    entry = next(e for e in exe._cache.values() if e.grad_of)
    ops = main.global_block().ops
    first_grad = next(i for i, op in enumerate(ops)
                      if op.type.endswith("_grad"))
    ck_ops = {i for i, op in enumerate(ops) if any(
        n in {v.name for v in io["checkpoints"]}
        for n in op.output_arg_names())}
    taped_originals = [i for i in entry.tape if i < first_grad
                       and i not in ck_ops]
    # the tail after the last checkpoint (final layer norm, CE, mean) is
    # not recomputed: its ops stay on the tape
    tail = min(i for i in ck_ops if i == max(ck_ops))
    assert all(i > tail for i in taped_originals)
    assert sorted(ops[i].type for i in entry.regrad) == [
        "elementwise_add_grad"] * _CFG["n_layer"]


# -- the device's random stream ------------------------------------------


def test_the_hash_has_the_same_bits_on_tensors_and_ints():
    for seed_step in ((0, 0), (7, 3), (2 ** 40 + 5, 2 ** 33 + 1)):
        key_t = registry.step_key(torch.tensor(seed_step))
        key_i = registry.step_key(seed_step)
        assert int(key_t) == key_i
        bits = registry.draw_bits(key_t, 3, (5, 7), "cpu")
        assert torch.equal(bits, registry.draw_bits(key_i, 3, (5, 7), "cpu"))
        assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    x = torch.arange(0, 2 ** 32, 2 ** 20 + 7, dtype=torch.int64)
    assert [int(v) for v in registry.mix32(x)] == [
        registry.mix32(int(v)) for v in x]


def _dropout_program():
    return _torch_program(False, 0.5, dict(_CFG, n_layer=2))


def _attn_out(main):
    return next(op.output("Out")[0] for op in main.global_block().ops
                if op.type == "fused_attention_tpu")


def test_staged_draws_equal_eager_and_change_every_step():
    program = _dropout_program()
    start = _start(program)
    attn = _attn_out(program[0])
    eager = _torch_steps(program, start, steps=4, fetch=[attn])
    staged = _torch_steps(program, start, steps=4, staged=True,
                          fetch=[attn])
    assert staged[3].phases == {"eager": 1, "capture": 1, "replay": 2}
    assert staged[0] == eager[0]
    assert staged[3].seed_step.tolist() == eager[3].seed_step.tolist() == [
        7, 4]
    masks = [f[0] != 0 for f in staged[2]]
    for (e,), (s,) in zip(eager[2], staged[2]):
        np.testing.assert_array_equal(e, s)
    for a, b in zip(masks, masks[1:]):
        assert (a != b).any()
    share = np.mean([m.mean() for m in masks])
    assert abs(share - 0.5) < 0.05


def test_a_clone_redraws_its_forward_mask():
    main, startup, io = _torch_program(True, 0.5, dict(_CFG, n_layer=2))
    ops = main.global_block().ops
    attn = [op for op in ops if op.type == "fused_attention_tpu"]
    original = attn[0].output("Out")[0]
    clone = next(op.output("Out")[0] for op in attn[1:]
                 if op.all_attrs()["_rng_id"] == attn[0].all_attrs()["_rng_id"])
    assert "@RECOMPUTE" in clone
    _, _, fetched, _ = _torch_steps((main, startup, io),
                                    _start((main, startup, io)), steps=2,
                                    fetch=[original, clone])
    for a, b in fetched:
        np.testing.assert_array_equal(a, b)
        assert (a == 0).any()
    assert not np.array_equal(fetched[0][0] == 0, fetched[1][0] == 0)


def test_a_fixed_seed_attribute_keeps_its_draw():
    startup = Program()
    startup.random_seed = 3
    block = startup.global_block()
    UniformInitializer(-1.0, 1.0, seed=42)(
        block.create_var(name="w", shape=(32,), dtype="float32",
                         persistable=True), block)
    UniformInitializer(-1.0, 1.0)(
        block.create_var(name="u", shape=(32,), dtype="float32",
                         persistable=True), block)
    scope, exe = Scope(), Executor(CPUPlace())
    exe.staged = True
    draws = []
    for _ in range(3):
        exe.run(startup, scope=scope)
        draws.append((scope.get("w").clone(), scope.get("u").clone()))
    assert all(torch.equal(draws[0][0], w) for w, _ in draws)
    assert not torch.equal(draws[0][1], draws[1][1])


# -- liveness --------------------------------------------------------------


def test_an_intermediate_dies_before_the_step_ends(monkeypatch):
    """Right after the op that last reads it, a value leaves the step: a
    weakref to the first layer norm's output dies while later ops run,
    and the fetch, the feeds and the parameters are still there at the
    end."""
    main, startup, io = _torch_program(False)
    ops = main.global_block().ops
    ln = next(i for i, op in enumerate(ops) if op.type == "layer_norm")
    name = ops[ln].output("Y")[0]
    last = max(i for i, op in enumerate(ops)
               if name in op.input_arg_names() + op.output_arg_names())
    assert last < len(ops) - 10
    start = _start((main, startup, io))
    refs, seen = {}, {}
    real = texecutor.lower_op

    def watch(ctx, op, env, op_idx=None):
        real(ctx, op, env, op_idx)
        if op_idx == ln:
            refs["y"] = weakref.ref(env[name])
        if op_idx == last + 5:
            gc.collect()
            seen["alive"] = refs["y"]() is not None
            seen["in_env"] = name in env
        if op_idx == len(ops) - 1:
            seen["kept"] = ([n in env for n in ("tokens", "labels")]
                            + [p.name in env for p in main.all_parameters()])

    monkeypatch.setattr(texecutor, "lower_op", watch)
    losses, _, _, exe = _torch_steps((main, startup, io), start, steps=1)
    assert seen == {"alive": False, "in_env": False,
                    "kept": [True] * (2 + len(main.all_parameters()))}
    assert np.isfinite(losses[0])
    entry = next(e for e in exe._cache.values() if e.grad_of)
    dropped = {n for names in entry.drop.values() for n in names}
    assert name in dropped and io["loss"].name not in dropped
    assert not dropped & {p.name for p in main.all_parameters()}


def test_liveness_keeps_fetches_feeds_and_persistables():
    main, startup, io = _torch_program(False)
    plan = texecutor.liveness(main.global_block(),
                              {io["loss"].name, "tokens", "labels"})
    dropped = {n for names in plan.values() for n in names}
    assert {io["loss"].name, "tokens", "labels"}.isdisjoint(dropped)
    assert not any(main.global_block().var(n).persistable for n in dropped)
    assert len(dropped) > 100


# -- the chunked lm-head CE --------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_chunked_ce_matches_the_jax_package(dtype, rtol):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.framework import registry as jreg

    b, t, d, v, chunk = 2, 11, 16, 40, 8  # N 22: padded to 24
    r = np.random.RandomState(3)
    x = r.randn(b, t, d).astype(np.float32)
    w = (0.3 * r.randn(v, d)).astype(np.float32)
    lbl = r.randint(0, v, (b, t)).astype(np.int64)
    g = r.uniform(0.5, 1.5, (b, t, 1)).astype(np.float32)
    attrs = {"impl": "chunked", "chunk_size": chunk}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jrule = jreg.get_op_def("fused_lm_head_ce").lower

    def jloss(xx, ww):
        return jrule(jreg.LoweringContext(), {
            "X": [xx], "W": [ww], "Label": [jnp.asarray(lbl)]},
            attrs)["Loss"]

    jl, vjp = jax.vjp(jloss, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(g))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    tl = registry.get_op_def("fused_lm_head_ce").lower(
        registry.LoweringContext("cpu"),
        {"X": [tx], "W": [tw], "Label": [torch.from_numpy(lbl)]},
        attrs)["Loss"]
    tdx, tdw = torch.autograd.grad(tl, (tx, tw), torch.from_numpy(g))
    assert tl.dtype == torch.float32 and tdx.dtype == tdt
    for got, want in ((tl, jl), (tdx, jdx), (tdw, jdw)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=rtol * 1e-1)


def test_chunked_ce_trains_the_tiny_gpt():
    """``resolve_lm_head_impl`` selects "chunked" as the JAX package
    does, and the chunked program's steps equal the fused-kernel route's
    within fp32 rounding."""
    from paddle_tpu.models.gpt import resolve_lm_head_impl as jresolve

    for mode in ("chunked", "on", True, "pallas", "auto", "off", False):
        assert tgpt.resolve_lm_head_impl(tgpt.GPTConfig(
            fused_lm_head=mode)) == jresolve(jgpt.GPTConfig(
                fused_lm_head=mode))
    losses = {}
    for impl in ("chunked", "pallas"):
        cfg = dict(_CFG, fused_lm_head=impl)
        program = _torch_program(False, 0.0, cfg)
        ce = next(op for op in program[0].global_block().ops
                  if op.type == "fused_lm_head_ce")
        assert ce.all_attrs()["impl"] == impl
        losses[impl] = _torch_steps(program, _start(program))[0]
    np.testing.assert_allclose(losses["chunked"], losses["pallas"],
                               rtol=1e-5)


# -- set_device / get_device -------------------------------------------------


@pytest.fixture
def fresh_default(monkeypatch):
    monkeypatch.setattr(core, "_default_place", None)
    monkeypatch.delenv("PADDLE_TPU_DEFAULT_DEVICE", raising=False)


def test_set_device_names_the_default_place(fresh_default, monkeypatch):
    assert paddle_tpu_torch.get_device() == "gpu:0"
    assert core.default_place() == CUDAPlace(0)
    for name, place, shown in (("gpu", CUDAPlace(0), "gpu:0"),
                               ("cuda:1", CUDAPlace(1), "gpu:1"),
                               ("tpu:2", CUDAPlace(2), "gpu:2"),
                               ("cpu", CPUPlace(), "cpu")):
        assert paddle_tpu_torch.set_device(name) == place
        assert paddle_tpu_torch.get_device() == shown
        assert core.default_place() == place
    assert Executor().device == torch.device("cpu")
    with pytest.raises(errors.InvalidArgument):
        paddle_tpu_torch.set_device("npu")
    monkeypatch.setattr(core, "_default_place", None)
    monkeypatch.setenv("PADDLE_TPU_DEFAULT_DEVICE", "cpu")
    assert paddle_tpu_torch.get_device() == "cpu"


def test_no_card_and_the_default_place_still_raises(fresh_default,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.Unavailable):
        Executor()
    paddle_tpu_torch.set_device("gpu")
    with pytest.raises(errors.Unavailable):
        Executor()
    paddle_tpu_torch.set_device("cpu")
    assert Executor().device == torch.device("cpu")
