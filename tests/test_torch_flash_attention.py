"""The port's flash attention against the JAX package's pallas kernels.

The same numpy inputs go through the TPU kernels of
``paddle_tpu/ops/pallas/flash_attention.py``, run in pallas interpret
mode as the JAX package's own tests run them on the CPU, and through the
port's plain versions (``paddle_tpu_torch/ops/flash_attention.py``),
which the port's wrappers take for CPU tensors:

- out and lse from ``_fwd``;
- dq, dk and dv from ``_bwd``, fed the JAX forward's out and lse;
- the gradients of ``jax.grad`` of ``flash_attention`` against
  ``torch.autograd`` through ``FlashAttention``.

Cases: fp32 and bf16, causal and not, BTHD and BHTD, D = 64 and 128, and
causal Tq != Tk (bottom-right aligned). Tolerances follow
``tests/test_flash_attention.py``: fp32 out and lse at 2e-5, gradients at
2e-4; bf16 at 2e-2 (the port rounds the fp32 scores times the scale where
the TPU's BTHD kernel rounds q * scale first, and its online softmax
rounds P against the running max where the plain version rounds the
normalized P).
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention  # noqa: F401

from paddle_tpu_torch.ops import flash_attention as fl

jfa = sys.modules["paddle_tpu.ops.pallas.flash_attention"]

_TOL = {"f32": (2e-5, 2e-4), "bf16": (2e-2, 2e-2)}  # (forward, gradients)
_BLOCK = 128


def _inputs(b, h, tq, tk, d, dt, layout, seed=0):
    """q, k, v, dO as fp32 numpy values both sides hold exactly."""
    r = np.random.RandomState(seed)

    def make(t):
        shape = (b, t, h, d) if layout == "BTHD" else (b, h, t, d)
        a = r.randn(*shape).astype(np.float32)
        if dt == "bf16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a

    return make(tq), make(tk), make(tk), make(tq)


def _jax(a, dt):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _torch(a, dt):
    return torch.from_numpy(a).to(torch.bfloat16 if dt == "bf16"
                                  else torch.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(t, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


_CASES = [pytest.param(dt, layout, causal, 64, 256, 256,
                       id=f"{dt}-{layout}-{'causal' if causal else 'full'}")
          for dt in ("f32", "bf16") for layout in ("BTHD", "BHTD")
          for causal in (True, False)]
_CASES += [
    pytest.param("f32", "BTHD", True, 128, 256, 256, id="f32-BTHD-d128"),
    pytest.param("bf16", "BHTD", False, 128, 256, 256, id="bf16-BHTD-d128"),
    pytest.param("f32", "BHTD", True, 64, 128, 384,
                 id="f32-BHTD-tq128-tk384"),
    pytest.param("bf16", "BTHD", True, 64, 128, 384,
                 id="bf16-BTHD-tq128-tk384"),
]


@pytest.mark.parametrize("dt,layout,causal,d,tq,tk", _CASES)
def test_plain_versions_match_the_pallas_kernels(dt, layout, causal, d, tq,
                                                 tk):
    q, k, v, do = _inputs(1, 2, tq, tk, d, dt, layout)
    scale = 1.0 / np.sqrt(d)
    bthd = layout == "BTHD"
    jq, jk, jv, jdo = (_jax(a, dt) for a in (q, k, v, do))
    jout, jlse = jfa._fwd(jq, jk, jv, causal=causal, scale=scale,
                          block_q=_BLOCK, block_k=_BLOCK, interpret=True,
                          bthd=bthd)
    jgrads = jfa._bwd(causal, scale, _BLOCK, _BLOCK, True, bthd, None,
                      (jq, jk, jv, jout, jlse), jdo)

    tq_, tk_, tv_, tdo = (_torch(a, dt) for a in (q, k, v, do))
    out, lse = fl.flash_attention_fwd(tq_, tk_, tv_, causal, None, layout)
    fwd_tol, grad_tol = _TOL[dt]
    _close(out, jout, fwd_tol, "out")
    _close(lse, np.reshape(_np(jlse), lse.shape), fwd_tol, "lse")

    # the backward from the JAX forward's out and lse, as _bwd takes them
    jo = _torch(_np(jout), dt)
    jl = torch.from_numpy(np.reshape(_np(jlse), lse.shape).copy())
    delta = fl.flash_attention_delta(jo, tdo, layout)
    args = (tq_, tk_, tv_, tdo, jl, delta, causal, None, layout)
    dq = fl.flash_attention_dq(*args)
    dk, dv = fl.flash_attention_dkv(*args)
    for got, want, name in zip((dq, dk, dv), jgrads, ("dq", "dk", "dv")):
        assert got.dtype == tq_.dtype
        _close(got, want, grad_tol, name)


@pytest.mark.parametrize("layout,causal,tq,tk", [
    ("BTHD", True, 256, 256), ("BHTD", False, 256, 256),
    ("BHTD", True, 128, 384)])
def test_autograd_matches_jax_grad(layout, causal, tq, tk):
    """FlashAttention through torch.autograd against jax.grad of the
    JAX package's flash_attention, loss = sum(out ** 2), fp32."""
    q, k, v, _ = _inputs(2, 2, tq, tk, 64, "f32", layout, seed=1)

    def loss(a, b, c):
        return (jfa.flash_attention(a, b, c, causal=causal, block_q=_BLOCK,
                                    block_k=_BLOCK, layout=layout) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fl.flash_attention(*leaves, causal=causal, layout=layout)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, 2e-4, f"d{name}")


def test_fully_masked_rows_give_zero_and_the_stand_in_lse():
    """Causal with Tq > Tk: a query row that sees no key gets out 0 and
    lse -1e30 (the TPU kernel's value where such a row's whole block is
    skipped), and no gradient flows through it."""
    q, k, v, do = (_torch(a, "f32")
                   for a in _inputs(1, 1, 6, 4, 64, "f32", "BHTD"))
    out, lse = fl.flash_attention_fwd(q, k, v, True)
    assert torch.all(out[:, :, :2] == 0)
    assert torch.all(lse[:, :, :2] == -1e30)
    assert torch.isfinite(out).all()
    delta = fl.flash_attention_delta(out, do)
    dq = fl.flash_attention_dq(q, k, v, do, lse, delta, True)
    dk, dv = fl.flash_attention_dkv(q, k, v, do, lse, delta, True)
    assert torch.all(dq[:, :, :2] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="head_dim"):
        fl.flash_attention_fwd(*(torch.zeros((1, 8, 2, 32)),) * 3,
                               layout="BTHD")
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fl.flash_attention_fwd(x.half(), x.half(), x.half(), layout="BTHD")
    with pytest.raises(ValueError, match="layout"):
        fl.flash_attention_fwd(x, x, x, layout="BSHD")
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 8, 64)).transpose(1, 2)
        fl.flash_attention_fwd(t, t, t, layout="BTHD")
    with pytest.raises(ValueError, match="batch, heads or head_dim"):
        fl.flash_attention_fwd(x, torch.zeros((1, 8, 3, 64)),
                               torch.zeros((1, 8, 3, 64)), layout="BTHD")
    out, lse = fl.flash_attention_fwd(x, x, x, layout="BTHD")
    delta = fl.flash_attention_delta(out, x, "BTHD")
    with pytest.raises(ValueError, match="lse"):
        fl.flash_attention_dq(x, x, x, x, lse[:, :, :4], delta,
                              layout="BTHD")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        m = torch.zeros((1, 8, 2, 64), device="meta")
        fl.flash_attention_fwd(m, m, m, layout="BTHD")


def test_launch_counters_count_kernel_launches_only():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; reset_launches zeroes every counter."""
    fl.reset_launches()
    q = torch.randn((1, 2, 64, 64), requires_grad=True)
    fl.flash_attention(q, q, q, causal=True).sum().backward()
    assert (fl.fwd_launches, fl.dq_launches, fl.dkv_launches) == (0, 0, 0)
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("layout,shape", [
    ("BTHD", (2, 5, 3, 64)), ("BHTD", (2, 3, 5, 64)),
    ("BTHD", (3, 7, 2, 128)), ("BHTD", (1, 4, 9, 128))])
def test_tma_geometry_addresses_every_element(layout, shape):
    """The bf16 forward's rank-3 tensor map (dims (inner, T, outer),
    strides st_seq and st_outer) puts element (b, t, h, c) at coordinates
    inside the map and at the offset tensor.stride() gives it, in both
    layouts; a head's D columns never cross into the next head's."""
    t = torch.empty(shape)
    inner, outer, st_seq, st_outer, head_col, outer_b, outer_h = \
        fl.tma_geometry(t, layout)
    if layout == "BTHD":
        nb, nt, nh, d = shape
    else:
        nb, nh, nt, d = shape
    b, tt, h, c = np.meshgrid(np.arange(nb), np.arange(nt), np.arange(nh),
                              np.arange(d), indexing="ij")
    c0 = h * head_col + c
    c2 = b * outer_b + h * outer_h
    assert (c0 >= 0).all() and (c0 < inner).all()
    assert (c2 >= 0).all() and (c2 < outer).all()
    assert ((c0 - c) // d == h * head_col // d).all()  # whole heads
    s = t.stride()
    want = (b * s[0] + h * s[2 if layout == "BTHD" else 1]
            + tt * s[1 if layout == "BTHD" else 2] + c)
    np.testing.assert_array_equal(c0 + tt * st_seq + c2 * st_outer, want)
    assert inner * nt * outer == t.numel()
    assert st_seq * 2 % 16 == 0 and st_outer * 2 % 16 == 0  # TMA's pitch


class _Recorder:
    """Stands in for the kernels' library: records each call and returns
    ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


def _stub_library(monkeypatch, lib):
    from paddle_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


@pytest.mark.parametrize("dtype,d,layout,entry", [
    (torch.bfloat16, 64, "BTHD", "flash_attn_fwd_sm90"),
    (torch.bfloat16, 128, "BHTD", "flash_attn_fwd_sm90"),
    (torch.bfloat16, 256, "BTHD", "flash_attn_fwd"),
    (torch.float32, 64, "BHTD", "flash_attn_fwd"),
    (torch.float32, 128, "BTHD", "flash_attn_fwd")])
def test_forward_routes_bf16_to_the_tensor_core_kernel(monkeypatch, dtype, d,
                                                       layout, entry):
    """bf16 at head_dim 64 and 128 goes to the sm90 entry point, with the
    tensor-map geometry of q and of k; fp32, and bf16 at head_dim 256, to
    the SIMT one; one launch counted either way."""
    lib = _Recorder()
    _stub_library(monkeypatch, lib)
    q, k, v, _ = (_torch(a, "f32").to(dtype)
                  for a in _inputs(2, 3, 96, 160, d, "f32", layout))
    fl.reset_launches()
    out, lse = fl._launch_fwd(q, k, v, True, 0.125, layout)
    assert fl.fwd_launches == 1
    assert out.shape == q.shape and lse.shape == (2, 3, 96)
    (name, args), = lib.calls
    assert name == entry
    if entry == "flash_attn_fwd_sm90":
        assert args[5:10] == (2, 3, 96, 160, d)
        assert tuple(args[10]) == fl.tma_geometry(q, layout)
        assert tuple(args[11]) == fl.tma_geometry(k, layout)
        assert args[12:14] == (0.125, 1)


def test_forward_raises_on_a_refused_launch(monkeypatch):
    """A refused tensor map (or any error code) raises with the code; no
    launch is counted and the plain version is never taken."""
    calls = []
    monkeypatch.setattr(fl, "flash_attention_fwd_plain",
                        lambda *a: calls.append(a))
    lib = _Recorder(err=-3)
    _stub_library(monkeypatch, lib)
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16)
    fl.reset_launches()
    with pytest.raises(RuntimeError, match="error -3.*tensor map refused"):
        fl._launch_fwd(q, q, q, True, 0.125, "BTHD")
    assert fl.fwd_launches == 0 and calls == []


def test_ablation_tool_anchors_match_the_forward_kernel(monkeypatch):
    """tools/torch_flash_fwd_ablation.py edits the bf16 forward's source
    by text; each of its anchors (the exponential, the two wgmma calls,
    the producer's loads) must still be in the kernel, and each variant
    must differ from it."""
    import importlib.util
    import os

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools")
    monkeypatch.syspath_prepend(tools)
    spec = importlib.util.spec_from_file_location(
        "torch_flash_fwd_ablation",
        os.path.join(tools, "torch_flash_fwd_ablation.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(tool.SOURCE) as f:
        src = f.read()
    variants = tool.variants(src)
    assert variants["kernel"] == src
    assert len({text for text in variants.values()}) == len(variants)


@pytest.mark.parametrize("dtype,d,layout,sm90", [
    (torch.bfloat16, 64, "BTHD", True), (torch.bfloat16, 64, "BHTD", True),
    (torch.bfloat16, 128, "BTHD", True), (torch.bfloat16, 128, "BHTD", True),
    (torch.bfloat16, 256, "BTHD", False), (torch.float32, 64, "BHTD", False),
    (torch.float32, 128, "BTHD", False)])
@pytest.mark.parametrize("role", ["dq", "dkv"])
def test_backward_routes_bf16_to_the_tensor_core_kernels(monkeypatch, dtype, d,
                                                         layout, sm90, role):
    """bf16 at head_dim 64 and 128 goes to the sm90 dq and dk/dv entry
    points, with the tensor-map geometry of q (which dO shares) and of k;
    fp32, and bf16 at head_dim 256, to the SIMT ones; one launch counted
    either way, on that role's counter only."""
    lib = _Recorder()
    _stub_library(monkeypatch, lib)
    q, k, v, do = (_torch(a, "f32").to(dtype)
                   for a in _inputs(2, 3, 96, 160, d, "f32", layout))
    lse, delta = torch.zeros((2, 3, 96)), torch.zeros((2, 3, 96))
    fl.reset_launches()
    launch = fl._launch_dq if role == "dq" else fl._launch_dkv
    outs = launch(q, k, v, do, lse, delta, True, 0.125, layout)
    assert (fl.fwd_launches, fl.dq_launches, fl.dkv_launches) == (
        (0, 1, 0) if role == "dq" else (0, 0, 1))
    (name, args), = lib.calls
    entry = f"flash_attn_{role}" + ("_sm90" if sm90 else "")
    assert name == entry
    n_out = 1 if role == "dq" else 2
    if role == "dq":
        assert outs.shape == q.shape
    else:
        assert outs[0].shape == outs[1].shape == k.shape
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    assert list(args[:6]) == ptrs
    if sm90:
        dims = args[6 + n_out:]
        assert dims[:5] == (2, 3, 96, 160, d)
        assert tuple(dims[5]) == fl.tma_geometry(q, layout)
        assert tuple(dims[6]) == fl.tma_geometry(k, layout)
        assert dims[7:9] == (0.125, 1)


@pytest.mark.parametrize("role", ["dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_raises_on_a_refused_launch(monkeypatch, role, dtype):
    """A refused tensor map or launch raises with the error code; no launch
    is counted and the plain version is never taken."""
    calls = []
    for plain in ("flash_attention_dq_plain", "flash_attention_dkv_plain"):
        monkeypatch.setattr(fl, plain, lambda *a: calls.append(a))
    lib = _Recorder(err=-3)
    _stub_library(monkeypatch, lib)
    q = torch.zeros((1, 128, 2, 64), dtype=dtype)
    stats = torch.zeros((1, 2, 128))
    fl.reset_launches()
    launch = fl._launch_dq if role == "dq" else fl._launch_dkv
    with pytest.raises(RuntimeError, match="error -3"):
        launch(q, q, q, q, stats, stats, True, 0.125, "BTHD")
    assert (fl.dq_launches, fl.dkv_launches) == (0, 0) and calls == []


def test_backward_clones_a_misaligned_input(monkeypatch):
    """A bf16 input whose pointer is not 16-byte aligned (a view at an
    odd offset) reaches the tensor-core kernel as an aligned copy, as TMA
    needs."""
    lib = _Recorder()
    _stub_library(monkeypatch, lib)
    flat = torch.zeros(1 * 128 * 2 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(1, 128, 2, 64)
    assert q.data_ptr() % 16
    stats = torch.zeros((1, 2, 128))
    fl._launch_dkv(q, q, q, q, stats, stats, True, 0.125, "BTHD")
    (name, args), = lib.calls
    assert name == "flash_attn_dkv_sm90"
    assert all(a % 16 == 0 for a in args[:4])
