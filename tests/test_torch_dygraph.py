"""The port's eager API (dygraph tracer, Tensor, ops/api.py, amp) against
the JAX package, and its own behaviour.

Every functional op and Tensor overload of ``ops/api.py`` that the port
lowers runs in both packages on the same numpy inputs (a seed a case):
forward, then the gradients of ``sum(out * w)`` for a numpy ``w`` with
respect to every float input, at rtol 1e-5 in fp32 and 2e-2 in bf16 (each
with an atol of the same fraction of the reference tensor's largest
magnitude, plus 1e-6). The JAX package computes its side in a subprocess
(one for the module): a JAX static-mode leak in this worker cannot turn
it.

The differences kept on purpose are each shown on both packages: eager
dropout draws a new mask each step in the port and repeats its mask in
the reference; a bf16 tensor's ``numpy()`` is float32 in the port (numpy
has no bfloat16); a label equal to ``ignore_index`` = -100 adds nothing
to the port's cross-entropy, while the reference picks the logit at
``V - 100``.
"""
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import amp, errors, nn  # noqa: E402
from paddle_tpu_torch.framework import core  # noqa: E402
from paddle_tpu_torch.framework import program as framework  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _eager_on_cpu():
    """Dygraph mode (the default, which a static file in this worker may
    have left off) on the CPU place; restores both."""
    was_dygraph = pt.in_dygraph_mode()
    prev = core._default_place
    pt.disable_static()
    pt.set_device("cpu")
    try:
        yield
    finally:
        core._default_place = prev
        if not was_dygraph:
            pt.enable_static()


def _F(p):
    return p.nn.functional


def _pos(r, shape):
    return r.uniform(0.5, 2.0, shape).astype(np.float32)


def _f(r, shape):
    return r.randn(*shape).astype(np.float32)


# (name, fn(pkg, *tensors), [input maker(r)]): float inputs are
# differentiated; integer ones are indices or labels
A, B, M = (3, 4), (4, 5), (2, 3, 4)
CASES = [
    ("add", lambda p, x, y: x + y, [lambda r: _f(r, A)] * 2),
    ("add_bcast", lambda p, x, y: x + y, [lambda r: _f(r, M),
                                          lambda r: _f(r, (4,))]),
    ("radd", lambda p, x: 2.0 + x, [lambda r: _f(r, A)]),
    ("sub", lambda p, x, y: x - y, [lambda r: _f(r, A)] * 2),
    ("rsub", lambda p, x: 2.0 - x, [lambda r: _f(r, A)]),
    ("mul", lambda p, x, y: x * y, [lambda r: _f(r, A)] * 2),
    ("rmul", lambda p, x: 3.0 * x, [lambda r: _f(r, A)]),
    ("div", lambda p, x, y: x / y, [lambda r: _f(r, A),
                                    lambda r: _pos(r, A)]),
    ("rdiv", lambda p, y: 1.0 / y, [lambda r: _pos(r, A)]),
    ("pow", lambda p, x: x ** 2, [lambda r: _f(r, A)]),
    ("neg", lambda p, x: -x, [lambda r: _f(r, A)]),
    ("matmul", lambda p, x, y: x @ y, [lambda r: _f(r, A),
                                       lambda r: _f(r, B)]),
    ("matmul_trans_y", lambda p, x, y: p.matmul(x, y, transpose_y=True),
     [lambda r: _f(r, A), lambda r: _f(r, (5, 4))]),
    ("bmm", lambda p, x, y: p.bmm(x, y), [lambda r: _f(r, M),
                                          lambda r: _f(r, (2, 4, 3))]),
    ("reshape", lambda p, x: x.reshape([4, 3]), [lambda r: _f(r, A)]),
    ("transpose", lambda p, x: x.transpose([2, 0, 1]), [lambda r: _f(r, M)]),
    ("sum_all", lambda p, x: x.sum(), [lambda r: _f(r, M)]),
    ("sum_axis", lambda p, x: x.sum(axis=1, keepdim=True),
     [lambda r: _f(r, M)]),
    ("mean_axis", lambda p, x: x.mean(axis=[0, 2]), [lambda r: _f(r, M)]),
    ("max_axis", lambda p, x: x.max(axis=1), [lambda r: _f(r, A)]),
    ("min_axis", lambda p, x: x.min(axis=0), [lambda r: _f(r, A)]),
    ("prod", lambda p, x: p.prod(x, axis=1), [lambda r: _pos(r, A)]),
    ("relu", lambda p, x: _F(p).relu(x), [lambda r: _f(r, A)]),
    ("sigmoid", lambda p, x: x.sigmoid(), [lambda r: _f(r, A)]),
    ("tanh", lambda p, x: x.tanh(), [lambda r: _f(r, A)]),
    ("exp", lambda p, x: x.exp(), [lambda r: _f(r, A)]),
    ("log", lambda p, x: x.log(), [lambda r: _pos(r, A)]),
    ("sqrt", lambda p, x: x.sqrt(), [lambda r: _pos(r, A)]),
    ("rsqrt", lambda p, x: p.rsqrt(x), [lambda r: _pos(r, A)]),
    ("abs", lambda p, x: x.abs(), [lambda r: _f(r, A)]),
    ("square", lambda p, x: x.square(), [lambda r: _f(r, A)]),
    ("softmax", lambda p, x: _F(p).softmax(x, axis=-1), [lambda r: _f(r, M)]),
    ("log_softmax", lambda p, x: _F(p).log_softmax(x, axis=1),
     [lambda r: _f(r, M)]),
    ("gelu", lambda p, x: _F(p).gelu(x), [lambda r: _f(r, A)]),
    ("gelu_tanh", lambda p, x: _F(p).gelu(x, approximate=True),
     [lambda r: _f(r, A)]),
    ("leaky_relu", lambda p, x: _F(p).leaky_relu(x, 0.1),
     [lambda r: _f(r, A)]),
    ("elu", lambda p, x: _F(p).elu(x, 0.5), [lambda r: _f(r, A)]),
    ("relu6", lambda p, x: _F(p).relu6(x * 4.0), [lambda r: _f(r, A)]),
    ("silu", lambda p, x: _F(p).silu(x), [lambda r: _f(r, A)]),
    ("softplus", lambda p, x: _F(p).softplus(x), [lambda r: _f(r, A)]),
    ("mse_loss", lambda p, x, y: _F(p).mse_loss(x, y), [lambda r: _f(r, A)]
     * 2),
    ("l1_loss", lambda p, x, y: _F(p).l1_loss(x, y, reduction="sum"),
     [lambda r: _f(r, A)] * 2),
    ("cross_entropy", lambda p, x, t: _F(p).cross_entropy(x, t),
     [lambda r: _f(r, (4, 5)),
      lambda r: r.randint(0, 5, (4,)).astype(np.int64)]),
    ("cross_entropy_3d", lambda p, x, t: _F(p).cross_entropy(
        x, t, reduction="none"),
     [lambda r: _f(r, (2, 3, 5)),
      lambda r: r.randint(0, 5, (2, 3)).astype(np.int64)]),
    ("linear", lambda p, x, w, b: _F(p).linear(x, w, b),
     [lambda r: _f(r, M), lambda r: _f(r, B), lambda r: _f(r, (5,))]),
    ("layer_norm", lambda p, x, w, b: _F(p).layer_norm(x, 4, w, b),
     [lambda r: _f(r, M), lambda r: _pos(r, (4,)), lambda r: _f(r, (4,))]),
    ("embedding", lambda p, i, w: _F(p).embedding(i, w),
     [lambda r: r.randint(0, 6, (2, 3)).astype(np.int64),
      lambda r: _f(r, (6, 4))]),
    ("dropout_eval", lambda p, x: _F(p).dropout(x, 0.5, training=False),
     [lambda r: _f(r, A)]),
    ("getitem_slice", lambda p, x: x[1:3], [lambda r: _f(r, M)]),
    ("getitem_int", lambda p, x: x[0, 1:3], [lambda r: _f(r, M)]),
    ("concat", lambda p, x, y: p.concat([x, y], axis=1),
     [lambda r: _f(r, A)] * 2),
    ("split", lambda p, x: p.split(x, 2, axis=1)[1], [lambda r: _f(r, A)]),
    ("split_sections", lambda p, x: p.split(x, [1, -1], axis=1)[1],
     [lambda r: _f(r, A)]),
    ("stack", lambda p, x, y: p.stack([x, y], axis=1),
     [lambda r: _f(r, A)] * 2),
    ("unsqueeze", lambda p, x: x.unsqueeze([0, 2]), [lambda r: _f(r, A)]),
    ("squeeze", lambda p, x: x.squeeze(1), [lambda r: _f(r, (3, 1, 4))]),
    ("flatten", lambda p, x: x.flatten(1), [lambda r: _f(r, M)]),
    ("cast", lambda p, x: p.cast(x, "float32") * 2.0, [lambda r: _f(r, A)]),
    ("gather", lambda p, x, i: p.gather(x, i, axis=1),
     [lambda r: _f(r, A), lambda r: np.array([3, 0, 3], np.int64)]),
    ("where", lambda p, x, y: p.where(x > y, x, y), [lambda r: _f(r, A)] * 2),
    ("maximum", lambda p, x, y: p.maximum(x, y), [lambda r: _f(r, A)] * 2),
    ("minimum", lambda p, x, y: p.minimum(x, y), [lambda r: _f(r, A)] * 2),
    ("clip", lambda p, x: p.clip(x, -0.5, 0.5), [lambda r: _f(r, A)]),
    ("scale", lambda p, x: p.scale(x, 2.0, 1.0), [lambda r: _f(r, A)]),
    ("sdpa", lambda p, q, k, v: _F(p).scaled_dot_product_attention(
        q, k, v, training=False),
     [lambda r: _f(r, (1, 2, 4, 8))] * 3),
    ("sdpa_causal", lambda p, q, k, v: _F(p).scaled_dot_product_attention(
        q, k, v, is_causal=True, training=False),
     [lambda r: _f(r, (1, 2, 4, 8))] * 3),
    # outputs that carry no gradient
    ("equal", lambda p, x, y: x == y, [lambda r: np.round(_f(r, A))] * 2),
    ("not_equal", lambda p, x, y: x != y, [lambda r: np.round(_f(r, A))] * 2),
    ("less_than", lambda p, x, y: x < y, [lambda r: _f(r, A)] * 2),
    ("less_equal", lambda p, x, y: x <= y, [lambda r: _f(r, A)] * 2),
    ("greater_than", lambda p, x, y: x > y, [lambda r: _f(r, A)] * 2),
    ("greater_equal", lambda p, x, y: x >= y, [lambda r: _f(r, A)] * 2),
    ("argmax", lambda p, x: x.argmax(axis=1), [lambda r: _f(r, A)]),
    ("zeros_like", lambda p, x: p.zeros_like(x), [lambda r: _f(r, A)]),
    ("ones", lambda p: p.ones([2, 3]), []),
    ("full", lambda p: p.full([2, 2], 1.5), []),
    ("arange", lambda p: p.arange(2, 10, 3), []),
]
# the bf16 cases (inputs bf16)
BF16 = ["add", "mul", "matmul", "bmm", "sum_all", "mean_axis", "relu",
        "gelu", "softmax", "linear", "layer_norm", "reshape", "transpose",
        "sdpa"]
PARAMS = ([(c[0], "float32") for c in CASES]
          + [(n, "bfloat16") for n in BF16])
_BY_NAME = {c[0]: c for c in CASES}


def _as_f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _run_case(pkg, name, dtype):
    """{"out": .., "grad<i>": ..} of one case in ``pkg``."""
    _, fn, makers = _BY_NAME[name]
    r = np.random.RandomState(zlib.crc32(name.encode()) % (1 << 31))
    arrs = [m(r) for m in makers]
    ts = [pkg.to_tensor(a, dtype=dtype, stop_gradient=False)
          if a.dtype.kind == "f" else pkg.to_tensor(a) for a in arrs]
    out = fn(pkg, *ts)
    res = {"out": _as_f32(out.numpy())}
    if res["out"].dtype.kind == "f" and not out.stop_gradient:
        w = np.asarray(r.randn(*res["out"].shape), np.float32)
        loss = pkg.sum(pkg.multiply(pkg.cast(out, "float32"),
                                    pkg.to_tensor(w)))
        loss.backward()
        for i, t in enumerate(ts):
            if t.grad is not None:  # a float input that is differentiated
                res[f"grad{i}"] = _as_f32(t.grad.numpy())
    return res


def _dropout_masks(pkg, steps=3):
    """Linear -> F.dropout(p=0.5) -> mean -> backward, ``steps`` times:
    each step's zero pattern of the dropout's output."""
    lin = pkg.nn.Linear(16, 16)
    x = pkg.to_tensor(np.ones((4, 16), np.float32) + np.arange(
        16, dtype=np.float32) / 16.0)
    masks = []
    for _ in range(steps):
        out = pkg.nn.functional.dropout(lin(x), p=0.5)
        masks.append(_as_f32(out.numpy()) == 0)
        out.mean().backward()
    return np.stack(masks)


def _ignored_label_loss(pkg):
    r = np.random.RandomState(7)
    logits = r.randn(3, 256).astype(np.float32)
    labels = np.array([5, -100, 17], np.int64)
    return _as_f32(pkg.nn.functional.cross_entropy(
        pkg.to_tensor(logits), pkg.to_tensor(labels),
        reduction="none").numpy()).reshape(-1), logits


def _reference_main(out):
    """Run in a subprocess: every case and kept difference in the JAX
    package, saved to ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd

    res = {}
    for name, dtype in PARAMS:
        for k, v in _run_case(pd, name, dtype).items():
            res[f"{name}/{dtype}/{k}"] = v
    res["dropout_masks"] = _dropout_masks(pd)
    res["bf16_numpy_dtype"] = np.asarray(
        pd.to_tensor(np.ones(2, np.float32), dtype="bfloat16").numpy()
        .dtype.name)
    res["ignored_label_loss"] = _ignored_label_loss(pd)[0]
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dygraph_ref") / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main({out!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,dtype", PARAMS)
def test_op_matches_the_reference(reference, name, dtype):
    got = _run_case(pt, name, dtype)
    want = {k.split("/", 2)[2]: v for k, v in reference.items()
            if k.startswith(f"{name}/{dtype}/")}
    assert sorted(got) == sorted(want)
    tol = TOL[dtype]
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=1e-6 + tol * float(np.abs(w).max(
                initial=0.0)), err_msg=k)


def test_eager_dropout_draws_anew_where_the_reference_repeats(reference):
    """Kept difference: the reference's tape restarts its random-op count
    at every backward and its key never advances, so each step repeats the
    mask; the port keys each draw on (seed, step) and the step advances at
    each backward."""
    ref = reference["dropout_masks"]
    assert all((ref[i] == ref[0]).all() for i in range(1, len(ref)))
    got = _dropout_masks(pt)
    assert all((got[i] != got[i - 1]).any() for i in range(1, len(got)))
    assert 0.3 < got.mean() < 0.7


def test_bf16_numpy_is_float32(reference):
    """Kept difference: numpy has no bfloat16 (the reference hands out
    ml_dtypes' type); the port's ``numpy()`` of a bf16 tensor is the exact
    float32 of its values."""
    assert str(reference["bf16_numpy_dtype"]) == "bfloat16"
    x = np.array([1.0, 1.0 + 2 ** -9, 3.14159], np.float32)
    t = pt.to_tensor(x, dtype="bfloat16")
    got = t.numpy()
    assert t.dtype == torch.bfloat16 and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def test_ignored_label_adds_nothing_where_the_reference_counts_it(
        reference):
    """Kept difference: a label of -100 (``ignore_index``) gives 0 in the
    port; the reference's rule masks only a non-negative ignore_index, so
    it picks the logit at ``V - 100``."""
    got, logits = _ignored_label_loss(pt)
    ref = reference["ignored_label_loss"]
    assert got[1] == 0.0
    lse = np.log(np.exp(logits[1].astype(np.float64)).sum())
    assert ref[1] == pytest.approx(lse - logits[1, 256 - 100], rel=1e-5)
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], rtol=1e-5)


# -- the port's own behaviour ------------------------------------------------


def test_import_enables_dygraph_and_static_switches():
    assert pt.in_dygraph_mode()
    pt.enable_static()
    try:
        assert not pt.in_dygraph_mode()
        assert framework._current_tracer() is None
    finally:
        pt.disable_static()
    assert pt.in_dygraph_mode()


def test_no_card_and_default_place_raises(monkeypatch):
    monkeypatch.setattr(core, "_default_place", None)
    monkeypatch.delenv("PADDLE_TPU_DEFAULT_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.Unavailable):
        pt.to_tensor(np.ones(2, np.float32))
    with pytest.raises(errors.Unavailable):
        nn.Linear(2, 2)


def test_backward_accumulates_until_cleared():
    x = pt.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    (x * x).sum().backward()
    (x * 3.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 7.0])
    x.clear_grad()
    assert x.grad is None and x.is_leaf


def test_no_grad_records_nothing():
    x = pt.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    tracer = framework._current_tracer()
    n = len(tracer.program.global_block().ops)
    with pt.no_grad():
        y = x * 2.0
    assert y.stop_gradient and len(tracer.program.global_block().ops) == n

    @pt.no_grad()
    def double(t):
        return t * 2.0

    assert double(x).stop_gradient
    assert not (x * 2.0).stop_gradient


def test_grad_ready_hooks_fire_once_a_leaf_with_its_final_grad():
    lin = nn.Linear(3, 2)
    seen = {}
    tracer = framework._current_tracer()
    hook = tracer.register_grad_ready_hook(
        lambda name, g: seen.setdefault(name, g.clone()))
    try:
        x = pt.to_tensor(np.ones((4, 3), np.float32))
        (lin(x) * lin(x)).sum().backward()
    finally:
        tracer.remove_grad_ready_hook(hook)
    assert set(seen) == {lin.weight.name, lin.bias.name}
    torch.testing.assert_close(seen[lin.weight.name], lin.weight.grad._value)


def test_step_advances_at_each_backward_and_seed_restarts_it():
    tracer = framework._current_tracer()
    pt.seed(11)
    assert tracer.seed_step == (11, 0)
    x = pt.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    (x * 2.0).sum().backward()
    assert tracer.seed_step == (11, 1)
    pt.seed(11)
    assert tracer.seed_step == (11, 0)


def test_optimizer_step_updates_in_place_and_state_round_trips():
    lin = nn.Linear(3, 2)
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=lin.parameters())
    w0 = lin.weight.numpy().copy()
    value = lin.weight._value
    x = pt.to_tensor(np.ones((4, 3), np.float32))
    lin(x).sum().backward()
    opt.step()
    opt.clear_grad()
    assert lin.weight._value is value  # the fused Adam wrapper's in place
    assert lin.weight.grad is None
    assert not np.allclose(lin.weight.numpy(), w0)
    state = opt.state_dict()
    assert len(state) == 8 and all(v.dtype == np.float32
                                   for v in state.values())
    opt.set_state_dict({k: np.zeros_like(v) for k, v in state.items()})
    assert all(not v.any() for v in opt.state_dict().values())
    opt.set_state_dict(state)
    for k, v in opt.state_dict().items():
        np.testing.assert_array_equal(v, state[k])


def test_accumulators_are_fp32_beside_bf16_params():
    lin = nn.Linear(4, 4)
    amp.decorate(lin, level="O2")
    assert lin.weight.dtype == torch.bfloat16
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=lin.parameters())
    lin(pt.to_tensor(np.ones((2, 4), np.float32), dtype="bfloat16")).sum() \
        .backward()
    assert lin.weight.grad.dtype == torch.bfloat16
    opt.step()
    accs = opt._accumulators["moment1"].values()
    assert all(a.dtype == torch.float32 for a in accs)


def test_auto_cast_runs_white_list_in_bf16_with_fp32_param_grads():
    lin = nn.Linear(4, 3)
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    with amp.auto_cast(dtype="bfloat16"):
        mm = pt.matmul(x, lin.weight)
        out = lin(x)
        sm = nn.functional.softmax(mm.astype("bfloat16"))
    assert mm.dtype == torch.bfloat16
    assert out.dtype == torch.float32  # bf16 product + fp32 bias
    assert sm.dtype == torch.float32  # black list: fp32
    out.sum().backward()
    assert lin.weight.grad.dtype == torch.float32


def test_grad_scaler_passes_bf16_through_and_scales_fp16():
    with amp.auto_cast(dtype="bfloat16"):
        assert not amp.GradScaler().is_enable()
    with amp.auto_cast(dtype="float16"):
        scaler = amp.GradScaler(init_loss_scaling=8.0)
    lin = nn.Linear(2, 1)
    opt = pt.optimizer.SGD(learning_rate=0.0, parameters=lin.parameters())
    x = pt.to_tensor(np.ones((1, 2), np.float32))
    loss = lin(x).sum()
    assert float(scaler.scale(loss)) == pytest.approx(8.0 * float(loss))
    scaler.scale(lin(x).sum()).backward()
    g = lin.weight.grad.numpy().copy()
    scaler.step(opt)
    np.testing.assert_allclose(lin.weight.grad.numpy(), g / 8.0)


def test_parameters_come_from_the_initializers():
    pt.seed(3)
    lin = nn.Linear(64, 32)
    w = lin.weight.numpy()
    limit = np.sqrt(6.0 / (64 + 32))
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit
    assert (lin.bias.numpy() == 0).all()
    pt.seed(3)
    again = nn.Linear(64, 32)
    assert not np.array_equal(again.weight.numpy(), w)  # a new index


def test_tensor_basics():
    t = pt.to_tensor([[1, 2], [3, 4]])
    assert t.dtype == torch.int64 and t.shape == (2, 2) and len(t) == 2
    f = pt.to_tensor(np.array([1.5], np.float64))
    assert f.dtype == torch.float32 and float(f) == 1.5
    assert t.place == torch.device("cpu")
    c = pt.to_tensor(np.ones(2, np.float32), place="cpu",
                     stop_gradient=False).clone()
    assert not c.stop_gradient and not c.is_leaf
    t.set_value(np.zeros((2, 2)))
    assert t.dtype == torch.int64 and int(t.sum()) == 0
