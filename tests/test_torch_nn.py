"""Every ``nn`` layer the port lowers, against the JAX package.

Each case builds one layer (or a small stack) in both packages at small
widths, carries the JAX package's initial weights into the port
(``weights.layer_from_numpy``), runs the same numpy inputs forward, then
the gradients of ``sum(out * w)`` (a numpy ``w``) with respect to every
parameter and float input: at rtol 1e-5 in fp32 and 2e-2 in bf16 (each
with an atol of the same fraction of the reference tensor's largest
magnitude, plus 1e-6). A bf16 case casts the layer's parameters with
``amp.decorate(level="O2")`` and feeds bf16 inputs. The JAX package
computes its side in one subprocess for the module.

The convolution, pooling and normalization classes other than LayerNorm
are ported as classes; their ops wait for A11, so a call raises the
registry's ``Unimplemented`` naming A11.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import errors  # noqa: E402
from paddle_tpu_torch.framework import core  # noqa: E402
from paddle_tpu_torch.weights import layer_from_numpy  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _eager_on_cpu():
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


def _f(shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def _ids(high, shape):
    return lambda r: r.randint(0, high, shape).astype(np.int64)


def _probs(shape):
    return lambda r: r.uniform(0.05, 0.95, shape).astype(np.float32)


def _encoder_stack(p):
    nn = p.nn

    class Stack(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([nn.Linear(6, 6), nn.Linear(6, 6)])
            self.scales = nn.ParameterList([self.create_parameter([6])])

        def forward(self, x):
            for blk, s in zip(self.blocks, self.scales):
                x = blk(x) * s
            return self.blocks[1](x)

    return Stack()


# (name, make(pkg) -> layer, [input makers], forward(layer, *tensors))
CASES = [
    ("Linear", lambda p: p.nn.Linear(5, 3), [_f((2, 4, 5))], None),
    ("Linear_no_bias", lambda p: p.nn.Linear(5, 3, bias_attr=False),
     [_f((4, 5))], None),
    ("Embedding", lambda p: p.nn.Embedding(10, 4), [_ids(10, (2, 3))], None),
    ("Embedding_padding", lambda p: p.nn.Embedding(10, 4, padding_idx=0),
     [_ids(3, (2, 5))], None),
    ("LayerNorm", lambda p: p.nn.LayerNorm(6), [_f((2, 3, 6))], None),
    ("Dropout_eval", lambda p: p.nn.Dropout(0.5).eval(), [_f((3, 4))], None),
    ("Dropout_p0", lambda p: p.nn.Dropout(0.0), [_f((3, 4))], None),
    ("Flatten", lambda p: p.nn.Flatten(), [_f((2, 3, 4))], None),
    ("ReLU", lambda p: p.nn.ReLU(), [_f((3, 4))], None),
    ("GELU", lambda p: p.nn.GELU(), [_f((3, 4))], None),
    ("Sigmoid", lambda p: p.nn.Sigmoid(), [_f((3, 4))], None),
    ("Tanh", lambda p: p.nn.Tanh(), [_f((3, 4))], None),
    ("LeakyReLU", lambda p: p.nn.LeakyReLU(0.1), [_f((3, 4))], None),
    ("ReLU6", lambda p: p.nn.ReLU6(), [lambda r: 5 * _f((3, 4))(r)], None),
    ("SiLU", lambda p: p.nn.SiLU(), [_f((3, 4))], None),
    ("Swish", lambda p: p.nn.Swish(), [_f((3, 4))], None),
    ("Mish", lambda p: p.nn.Mish(), [_f((3, 4))], None),
    ("Hardswish", lambda p: p.nn.Hardswish(), [lambda r: 4 * _f((3, 4))(r)],
     None),
    ("Hardsigmoid", lambda p: p.nn.Hardsigmoid(),
     [lambda r: 4 * _f((3, 4))(r)], None),
    ("ELU", lambda p: p.nn.ELU(0.5), [_f((3, 4))], None),
    ("SELU", lambda p: p.nn.SELU(), [_f((3, 4))], None),
    ("Softplus", lambda p: p.nn.Softplus(), [_f((3, 4))], None),
    ("Softmax", lambda p: p.nn.Softmax(axis=1), [_f((2, 3, 4))], None),
    ("LogSoftmax", lambda p: p.nn.LogSoftmax(), [_f((2, 3, 4))], None),
    ("Sequential", lambda p: p.nn.Sequential(
        p.nn.Linear(4, 8), p.nn.ReLU(), p.nn.Linear(8, 2)), [_f((3, 4))],
     None),
    ("LayerList_ParameterList", _encoder_stack, [_f((2, 6))], None),
    ("CrossEntropyLoss", lambda p: p.nn.CrossEntropyLoss(),
     [_f((4, 5)), _ids(5, (4,))], None),
    ("MSELoss", lambda p: p.nn.MSELoss(), [_f((3, 4)), _f((3, 4))], None),
    ("L1Loss", lambda p: p.nn.L1Loss(reduction="sum"),
     [_f((3, 4)), _f((3, 4))], None),
    ("BCELoss", lambda p: p.nn.BCELoss(), [_probs((3, 4)), _probs((3, 4))],
     None),
    ("BCEWithLogitsLoss", lambda p: p.nn.BCEWithLogitsLoss(),
     [_f((3, 4)), _probs((3, 4))], None),
    ("NLLLoss", lambda p: p.nn.NLLLoss(), [_f((4, 5)), _ids(5, (4,))],
     None),
    ("KLDivLoss", lambda p: p.nn.KLDivLoss(), [_f((3, 4)), _probs((3, 4))],
     None),
    ("SmoothL1Loss", lambda p: p.nn.SmoothL1Loss(),
     [lambda r: 3 * _f((3, 4))(r), _f((3, 4))], None),
    ("MultiHeadAttention", lambda p: p.nn.MultiHeadAttention(16, 2),
     [_f((2, 5, 16))], None),
    ("MultiHeadAttention_cross", lambda p: p.nn.MultiHeadAttention(
        16, 4, kdim=8, vdim=8), [_f((2, 5, 16)), _f((2, 3, 8))],
     lambda layer, q, kv: layer(q, kv, kv)),
    ("MultiHeadAttention_mask", lambda p: p.nn.MultiHeadAttention(16, 2),
     [_f((2, 5, 16)), lambda r: np.where(
         np.tril(np.ones((5, 5), bool)), 0.0, -1e9).astype(np.float32)],
     lambda layer, x, m: layer(x, attn_mask=m)),
    ("TransformerEncoderLayer_prenorm", lambda p:
     p.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                  activation="gelu", normalize_before=True),
     [_f((2, 5, 16))], None),
    ("TransformerEncoderLayer_postnorm", lambda p:
     p.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0), [_f((2, 5, 16))],
     None),
    ("TransformerEncoder", lambda p: p.nn.TransformerEncoder(
        p.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                     normalize_before=True), 2,
        norm=p.nn.LayerNorm(16)), [_f((2, 5, 16))], None),
    ("TransformerDecoderLayer", lambda p: p.nn.TransformerDecoderLayer(
        16, 2, 32, dropout=0.0), [_f((2, 4, 16)), _f((2, 5, 16))], None),
    ("TransformerDecoder", lambda p: p.nn.TransformerDecoder(
        p.nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                     normalize_before=True), 2),
     [_f((2, 4, 16)), _f((2, 5, 16))], None),
    ("Transformer", lambda p: p.nn.Transformer(
        16, 2, 1, 1, 32, dropout=0.0), [_f((2, 5, 16)), _f((2, 4, 16))],
     None),
]
BF16 = ["Linear", "LayerNorm", "GELU", "Sequential", "MultiHeadAttention",
        "TransformerEncoderLayer_prenorm"]
PARAMS = ([(c[0], "float32") for c in CASES]
          + [(n, "bfloat16") for n in BF16])
_BY_NAME = {c[0]: c for c in CASES}


def _as_f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _run_case(pkg, name, dtype, init=None):
    """(initial state_dict, {"out", "grad/<param>", "in<i>"}) of one case
    in ``pkg``; ``init`` (the reference's initial weights) replaces the
    port's."""
    _, make, makers, call = _BY_NAME[name]
    r = np.random.RandomState(zlib.crc32(name.encode()) % (1 << 31))
    layer = make(pkg)
    if init is not None:
        layer_from_numpy(layer, init)
    start = {k: _as_f32(v) for k, v in layer.state_dict().items()}
    if dtype == "bfloat16":
        pkg.amp.decorate(layer, level="O2")
    arrs = [m(r) for m in makers]
    ts = [pkg.to_tensor(a, dtype=dtype, stop_gradient=False)
          if a.dtype.kind == "f" else pkg.to_tensor(a) for a in arrs]
    out = (call or (lambda lyr, *xs: lyr(*xs)))(layer, *ts)
    res = {"out": _as_f32(out.numpy())}
    w = np.asarray(r.randn(*res["out"].shape), np.float32)
    pkg.sum(pkg.multiply(pkg.cast(out, "float32"), pkg.to_tensor(w))) \
        .backward()
    for qual, p in layer.named_parameters():
        if p.grad is not None:
            res[f"grad/{qual}"] = _as_f32(p.grad.numpy())
    for i, t in enumerate(ts):
        if t.grad is not None:
            res[f"in{i}"] = _as_f32(t.grad.numpy())
    return start, res


def _reference_main(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd

    res = {}
    for name, dtype in PARAMS:
        start, got = _run_case(pd, name, dtype)
        for k, v in start.items():
            res[f"{name}/{dtype}/init/{k}"] = v
        for k, v in got.items():
            res[f"{name}/{dtype}/res/{k}"] = v
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("nn_ref") / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main({out!r})")
    env = torch_threads.subprocess_env(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,dtype", PARAMS)
def test_layer_matches_the_reference(reference, name, dtype):
    pre = f"{name}/{dtype}/"
    init = {k[len(pre) + 5:]: v for k, v in reference.items()
            if k.startswith(pre + "init/")}
    want = {k[len(pre) + 4:]: v for k, v in reference.items()
            if k.startswith(pre + "res/")}
    _, got = _run_case(pt, name, dtype, init=init)
    assert sorted(got) == sorted(want)
    tol = TOL[dtype]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("k_proj.bias"):
            # 0 in exact arithmetic (softmax ignores a shift common to a
            # row's scores): rounding noise on both sides, held to the
            # tolerance's share of the key projection's gradient
            scale = tol * float(np.abs(want[k[:-4] + "weight"]).max())
            assert np.abs(w).max() <= scale and \
                np.abs(got[k]).max() <= scale, k
            continue
        np.testing.assert_allclose(
            got[k], w, rtol=tol,
            atol=1e-6 + tol * float(np.abs(w).max(initial=0.0)), err_msg=k)


def test_state_dict_names_match_the_reference(reference):
    """Structured names (``layers.0.self_attn.q_proj.weight`` ...) are the
    reference's, in its order."""
    pre = "TransformerEncoder/float32/init/"
    want = [k[len(pre):] for k in reference if k.startswith(pre)]
    layer = _BY_NAME["TransformerEncoder"][1](pt)
    assert list(layer.state_dict()) == want


UNPORTED = [
    ("Conv2D", lambda: pt.nn.Conv2D(3, 4, 3), (1, 3, 8, 8)),
    ("Conv2DTranspose", lambda: pt.nn.Conv2DTranspose(3, 4, 3),
     (1, 3, 8, 8)),
    ("MaxPool2D", lambda: pt.nn.MaxPool2D(2), (1, 3, 8, 8)),
    ("AvgPool2D", lambda: pt.nn.AvgPool2D(2), (1, 3, 8, 8)),
    ("AdaptiveAvgPool2D", lambda: pt.nn.AdaptiveAvgPool2D(1), (1, 3, 8, 8)),
    ("AdaptiveMaxPool2D", lambda: pt.nn.AdaptiveMaxPool2D(1), (1, 3, 8, 8)),
    ("BatchNorm2D", lambda: pt.nn.BatchNorm2D(3), (2, 3, 4, 4)),
    ("SyncBatchNorm", lambda: pt.nn.SyncBatchNorm(3), (2, 3, 4, 4)),
    ("GroupNorm", lambda: pt.nn.GroupNorm(1, 3), (2, 3, 4, 4)),
    ("InstanceNorm2D", lambda: pt.nn.InstanceNorm2D(3), (2, 3, 4, 4)),
]


@pytest.mark.parametrize("name,make,shape", UNPORTED,
                         ids=[u[0] for u in UNPORTED])
def test_unported_layers_name_a11(name, make, shape):
    layer = make()
    assert layer.parameters() or name.endswith("Pool2D")
    x = pt.to_tensor(np.ones(shape, np.float32))
    with pytest.raises(errors.Unimplemented, match="A11"):
        layer(x)


def test_layer_hooks_train_eval_and_set_state_dict():
    layer = pt.nn.Sequential(pt.nn.Linear(2, 2), pt.nn.Dropout(0.5))
    seen = []
    pre = layer.register_forward_pre_hook(lambda lyr, args: seen.append(1))
    post = layer.register_forward_post_hook(
        lambda lyr, args, out: out * 0.0)
    out = layer(pt.to_tensor(np.ones((1, 2), np.float32)))
    assert seen == [1] and float(out.abs().sum()) == 0.0
    pre.remove()
    post.remove()
    layer.eval()
    assert not any(l.training for l in layer.sublayers(include_self=True))
    layer.train()
    state = layer.state_dict()
    value = layer[0].weight._value
    assert layer.set_state_dict({k: v * 2 for k, v in state.items()}) == []
    assert layer[0].weight._value is value  # copied in place
    np.testing.assert_array_equal(layer[0].weight.numpy(),
                                  state["0.weight"] * 2)
    with pytest.raises(KeyError):
        layer_from_numpy(layer, {"0.weight": state["0.weight"]})
