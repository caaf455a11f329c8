"""The port's fused lm-head + CE (forward, dx, dW) against the JAX
package's.

The same numpy inputs go to ``paddle_tpu``'s pallas kernels (interpret
mode on the CPU, as its own tests run them; gradients by ``jax.grad``
through its custom VJP) and to ``paddle_tpu_torch``'s wrappers, which on
CPU tensors run their plain PyTorch versions (gradients through the
``LmheadCE`` autograd Function). The CUDA kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 at rtol = atol = 1e-5, the JAX kernel's own bound
against materialized logits (only the summation order differs); bf16 at
2e-3 for the loss and 5e-2 for dx and dW, the floors of
tests/test_fused_lmhead_ce.py:89 and :97-100 (both sides multiply bf16
inputs with fp32 accumulation and round the d-logits to bf16).
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.fused_lmhead_ce import lmhead_ce as jax_lmhead_ce
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import lmhead_ce as torch_ce


def _data(n, d, v, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(n, d) * 0.5).astype(np.float32)
    w = (r.randn(v, d) * 0.5).astype(np.float32)
    lbl = r.randint(0, v, (n,)).astype(np.int32)
    return x, w, lbl


def _jax(x, w, lbl, dtype=jnp.float32):
    return np.asarray(jax_lmhead_ce(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                    jnp.asarray(lbl), block_n=16, block_v=128))


@pytest.mark.parametrize("n,d,v", [(64, 64, 512), (48, 64, 300),
                                   (33, 32, 130)])
def test_fp32_matches_jax(n, d, v):
    x, w, lbl = _data(n, d, v)
    got = torch_ce.lmhead_ce(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(lbl))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), _jax(x, w, lbl),
                               rtol=1e-5, atol=1e-5)


def test_bf16_matches_jax():
    x, w, lbl = _data(64, 64, 512)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = torch_ce.lmhead_ce(xb, wb, torch.from_numpy(lbl))
    np.testing.assert_allclose(got.numpy(), _jax(x, w, lbl, jnp.bfloat16),
                               rtol=2e-3, atol=2e-3)


def test_out_of_range_labels_pick_nothing():
    """Labels V and -1 match no column: nll = lse in both packages."""
    n, d, v = 33, 32, 130
    x, w, lbl = _data(n, d, v, seed=2)
    lbl[3], lbl[7] = v, -1
    nll, lse = torch_ce.lmhead_ce_fwd(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(lbl))
    for row in (3, 7):
        assert nll[row].item() == lse[row].item()
    ref_lse = np.log(np.exp(x.astype(np.float64) @ w.T.astype(np.float64))
                     .sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)
    jx = _jax(x, w, lbl)
    np.testing.assert_allclose(jx[[3, 7]], ref_lse[[3, 7]],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nll.numpy(), jx, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, lbl = (torch.from_numpy(a) for a in _data(8, 16, 40))
    with pytest.raises(ValueError):
        torch_ce.lmhead_ce(x, w[:, :8].contiguous(), lbl)  # D mismatch
    with pytest.raises(ValueError):
        torch_ce.lmhead_ce(x.t(), w, lbl)  # shape
    with pytest.raises(ValueError):
        torch_ce.lmhead_ce(x[:, ::2], w[:, ::2], lbl)  # not contiguous
    with pytest.raises(TypeError):
        torch_ce.lmhead_ce(x.double(), w.double(), lbl)
    with pytest.raises(TypeError):
        torch_ce.lmhead_ce(x, w, lbl.float())
    lse = torch.zeros(8)
    with pytest.raises(ValueError, match="lse"):
        torch_ce.lmhead_ce_dx(x, w, lbl, lse[:4], lse)
    with pytest.raises(ValueError, match="g as"):
        torch_ce.lmhead_ce_dw(x, w, lbl, lse, lse.double())


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Only a CPU tensor reaches the plain version; any other device
    launches the kernel or raises."""
    calls = []
    monkeypatch.setattr(torch_ce, "lmhead_ce_plain",
                        lambda *a: calls.append(a))
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((16, 8), device="meta")
    lbl = torch.empty((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_ce.lmhead_ce(x, w, lbl)
    assert calls == []


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


@pytest.mark.parametrize("n,v", [(31, 32000), (127, 32000), (511, 32000),
                                 (33, 130), (1, 1), (600, 64)])
def test_vocab_split_covers_every_tile(n, v):
    """The partial launch's chunks tile the vocab exactly: every tile in
    one chunk, no chunk empty, and the grid fills a 132-SM card."""
    tile = 64
    per, chunks = torch_ce.split_vocab(n, v, tile, tile, sms=132)
    tiles = -(-v // tile)
    assert (chunks - 1) * per < tiles <= chunks * per
    token_blocks = -(-n // 64)
    assert token_blocks * chunks >= min(132, token_blocks * tiles)


def _jax_grads(x, w, lbl, g, dtype):
    """(nll, dx, dW) of sum(g * nll) through the JAX package's kernels."""
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    f = lambda a, b: jnp.vdot(jax_lmhead_ce(a, b, jnp.asarray(lbl),
                                            block_n=16, block_v=128),
                              jnp.asarray(g))
    nll = jax_lmhead_ce(xj, wj, jnp.asarray(lbl), block_n=16, block_v=128)
    dx, dw = jax.grad(f, argnums=(0, 1))(xj, wj)
    return (np.asarray(nll), np.asarray(dx, np.float32),
            np.asarray(dw, np.float32))


def _torch_grads(x, w, lbl, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    nll = torch_ce.lmhead_ce(xt, wt, torch.from_numpy(lbl))
    dx, dw = torch.autograd.grad(nll, (xt, wt), torch.from_numpy(g))
    assert dx.dtype == dtype and dw.dtype == dtype
    return (nll.detach().numpy(), dx.float().numpy(), dw.float().numpy())


@pytest.mark.parametrize("n,d,v,dtype,tol", [
    (64, 64, 512, "f32", 1e-5),
    (48, 64, 300, "f32", 1e-5),   # ragged N and V
    (33, 32, 130, "f32", 1e-5),   # ragged, labels V and -1 (below)
    (64, 64, 512, "bf16", 5e-2),
    (33, 32, 130, "bf16", 5e-2),
])
def test_backward_matches_jax(n, d, v, dtype, tol):
    """dx and dW with a non-uniform per-row g, labels V and -1 included:
    an out-of-range label hits no column."""
    x, w, lbl = _data(n, d, v, seed=5)
    lbl[3], lbl[7] = v, -1
    g = np.random.RandomState(6).uniform(0.5, 1.5, n).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax_grads(x, w, lbl, g, jdt)
    got = _torch_grads(x, w, lbl, g, tdt)
    ftol = tol if dtype == "f32" else 2e-3
    np.testing.assert_allclose(got[0], want[0], rtol=ftol, atol=ftol)
    for i, what in ((1, "dx"), (2, "dW")):
        np.testing.assert_allclose(got[i], want[i], rtol=tol, atol=tol,
                                   err_msg=what)


def test_backward_wrappers_are_the_autograd_function_s():
    """lmhead_ce_dx / lmhead_ce_dw (the kernels' wrappers) give what the
    autograd Function's backward gives, and g is taken per row."""
    x, w, lbl = (torch.from_numpy(a) for a in _data(20, 16, 70, seed=8))
    lbl[0] = -1
    g = torch.linspace(0.1, 2.0, 20)
    nll, lse = torch_ce.lmhead_ce_fwd(x, w, lbl)
    xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad(torch_ce.lmhead_ce(xt, wt, lbl), (xt, wt),
                                 g)
    torch.testing.assert_close(torch_ce.lmhead_ce_dx(x, w, lbl, lse, g), dx)
    torch.testing.assert_close(torch_ce.lmhead_ce_dw(x, w, lbl, lse, g), dw)
    # doubling one row's g doubles that row's dx and nothing else
    g2 = g.clone()
    g2[5] *= 2
    dx2 = torch_ce.lmhead_ce_dx(x, w, lbl, lse, g2)
    torch.testing.assert_close(dx2[5], 2 * dx[5])
    torch.testing.assert_close(dx2[6:], dx[6:])


@pytest.mark.parametrize("n,d", [
    (31, 768), (511, 768),          # serving score shapes
    (4096, 768), (16384, 768),      # dx at seq 512 and 2048
    (32768, 768),                   # dW: rows are the vocabulary
    (33, 64), (100, 1000), (64, 64), (1, 768), (600, 768)])  # edges
def test_sm90_blocks_cover_every_row_tile_and_d_half_once(n, d):
    """The bf16 backward's blocks tile the output exactly: every (row
    tile, D half) one block, and each block's two warpgroup slabs
    partition its half up to D, so every output element has one owner."""
    blocks = torch_ce.sm90_blocks(n, d)
    tiles, halves = -(-n // 64), -(-d // 384)
    assert len(blocks) == tiles * halves
    seen = {}
    for (r0, r1), slabs in blocks:
        assert r1 - r0 == min(64, n - r0) and r0 % 64 == 0
        cols = [c for lo, hi in slabs for c in range(lo, hi)]
        assert len(cols) == len(set(cols))
        for c in (cols[0], cols[-1]) if cols else ():
            assert 0 <= c < d
        half = slabs[0][0] // 384
        assert (r0, half) not in seen
        seen[(r0, half)] = cols
    for r0 in range(0, n, 64):
        owned = sorted(c for h in range(halves) for c in seen[(r0, h)])
        assert owned == list(range(d))
    if (n, d) == (4096, 768):  # dx at seq 512: one wave on 132 SMs
        assert len(blocks) == 128


@pytest.mark.parametrize("d", [60, 61, 1])
def test_zero_column_padding_keeps_plain_grads(d):
    """The sm90 wrapper's D padding (zero columns up to a multiple of 8)
    gives the plain dx and dW of the unpadded inputs in the first D
    columns, and zeros in the added ones."""
    n, v = 40, 70
    x, w, lbl = (torch.from_numpy(a) for a in _data(n, d, v, seed=9))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    g = torch.linspace(0.5, 1.5, n)
    xp, wp = torch_ce.pad_d(x, w)
    assert xp.shape[1] % 8 == 0 and xp.shape[1] - d < 8
    lse = torch_ce.lmhead_ce_plain(x, w, lbl)[1]
    assert torch.equal(torch_ce.lmhead_ce_plain(xp, wp, lbl)[1], lse)
    for plain in (torch_ce.lmhead_ce_dx_plain, torch_ce.lmhead_ce_dw_plain):
        full = plain(xp, wp, lbl, lse, g)
        assert torch.equal(full[:, :d], plain(x, w, lbl, lse, g))
        assert not full[:, d:].any()


class _Recorder:
    """Stands in for the kernels' library: records each backward entry
    point's call and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def lmhead_ce_tile_n(self):
        return 64

    def lmhead_ce_bwd_max_slab(self):
        return 768

    def lmhead_ce_sm90_max_d(self):
        return 1024


@pytest.mark.parametrize("dtype,d,entry", [
    (torch.bfloat16, 64, "lmhead_ce_bwd_sm90"),
    (torch.bfloat16, 60, "lmhead_ce_bwd_sm90"),
    (torch.float32, 64, "lmhead_ce_bwd_partial")])
def test_backward_routes_bf16_to_the_tensor_core_kernel(monkeypatch, dtype,
                                                         d, entry):
    """bf16 dx and dW go to the sm90 entry point (D padded to a multiple
    of 8 and cut back), fp32 to the SIMT one; one launch counted each."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch_ce, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    n, v = 48, 300
    x, w, lbl = (torch.from_numpy(a) for a in _data(n, d, v))
    x, w = x.to(dtype), w.to(dtype)
    lse, g = torch.zeros(n), torch.ones(n)
    torch_ce.reset_launches()
    dx = torch_ce._launch_dx(x, w, lbl, lse, g)
    dw = torch_ce._launch_dw(x, w, lbl, lse, g)
    assert (torch_ce.dx_launches, torch_ce.dw_launches) == (1, 1)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert dx.dtype == dw.dtype == dtype
    names = [name for name, _ in lib.calls]
    assert names[0] == names[-1] == entry
    assert "lmhead_ce_bwd_sm90" not in names or dtype == torch.bfloat16
    if entry == "lmhead_ce_bwd_sm90":
        (_, a_dx), (_, a_dw) = lib.calls
        # (rows, cols, d, token_rows) of each launch; d padded to 64
        assert a_dx[6:10] == (n, v, 64, 1) and a_dw[6:10] == (v, n, 64, 0)


def test_bf16_backward_above_its_widest_d_raises(monkeypatch):
    """bf16 D above the resident row tile's 1024 raises before a launch;
    fp32 takes the SIMT kernel at any D."""
    lib = _Recorder()
    monkeypatch.setattr(torch_ce, "_sms", lambda dev: 132)
    x, w, lbl = (torch.from_numpy(a) for a in _data(8, 1032, 40))
    lse, g = torch.zeros(8), torch.ones(8)
    with pytest.raises(ValueError, match="D <= 1024"):
        torch_ce._launch_bwd_side(lib, x.bfloat16(), w.bfloat16(), lbl, g,
                                  lse, 8, 40, True, 0)
    assert lib.calls == []
    torch_ce._launch_bwd_side(lib, x, w, lbl, g, lse, 8, 40, True, 0)
    assert [name for name, _ in lib.calls] == ["lmhead_ce_bwd_partial"]


def test_cuda_route_without_a_card_raises(monkeypatch, tmp_path):
    """With no compiler (no card's toolchain) the kernel route raises; it
    never falls back to the plain version."""
    calls = []
    monkeypatch.setattr(torch_ce, "lmhead_ce_dx_plain",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path / "b"))
    x, w, lbl = (torch.from_numpy(a) for a in _data(8, 16, 40))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        torch_ce._launch_dx(x, w, lbl, torch.zeros(8), torch.ones(8))
    assert calls == []


@pytest.mark.parametrize("n,v", [
    (4096, 32768), (16384, 32768),  # the training shapes
    (33, 130), (100, 300), (1, 300), (600, 5000), (511, 32000),  # edges
    (128, 128), (129, 129)])
def test_sm90_fwd_blocks_cover_every_row_tile_and_vocab_tile_once(n, v):
    """The bf16 forward's grid, in launch order (the row tile fastest),
    covers every (128-row tile, 128-column vocab tile) exactly once, with
    N and V ragged: no chunk starts at or past V, and rows and columns
    are clipped to N and V."""
    tn, tv = torch_ce.SM90_FWD_TILE_N, torch_ce.SM90_FWD_TILE_V
    blocks = torch_ce.sm90_fwd_blocks(n, v, sms=132)
    per, chunks = torch_ce.sm90_fwd_split(n, v, 132)
    row_tiles = -(-n // tn)
    seen = set()
    for i, ((r0, r1), (c0, c1)) in enumerate(blocks):
        assert r0 == (i % row_tiles) * tn and c0 == (i // row_tiles) * per * tv
        assert r1 == min(n, r0 + tn)
        assert c0 % tv == 0 and c0 < c1 <= v
        for c in range(c0, c1, tv):
            assert (r0, c) not in seen
            seen.add((r0, c))
    assert seen == {(r, c) for r in range(0, n, tn) for c in range(0, v, tv)}
    assert len(blocks) == row_tiles * chunks
    if (n, v) == (4096, 32768):  # several waves of one block per SM
        assert len(blocks) >= 4 * 132


class _FwdRecorder(_Recorder):
    """The library stand-in, with an error code for the forward's sm90
    entry points (bf16, and fp32 through split TF32)."""

    def __init__(self, err=0):
        super().__init__()
        self.err = err

    def lmhead_ce_fwd_sm90(self, *args):
        self.calls.append(("lmhead_ce_fwd_sm90", args))
        return self.err

    def lmhead_ce_fwd_f32_sm90(self, *args):
        self.calls.append(("lmhead_ce_fwd_f32_sm90", args))
        return self.err


def _stub_launch(monkeypatch, lib):
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch_ce, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


# the ids are those the cases had when fp32 took the SIMT partials
# ("lmhead_ce_partial"), kept so that runs before and after compare
@pytest.mark.parametrize("dtype,d,entry", [
    pytest.param(torch.bfloat16, 64, "lmhead_ce_fwd_sm90",
                 id="dtype0-64-lmhead_ce_fwd_sm90"),
    pytest.param(torch.bfloat16, 60, "lmhead_ce_fwd_sm90",
                 id="dtype1-60-lmhead_ce_fwd_sm90"),
    pytest.param(torch.float32, 64, "lmhead_ce_fwd_f32_sm90",
                 id="dtype2-64-lmhead_ce_partial")])
def test_forward_routes_bf16_to_the_tensor_core_kernel(monkeypatch, dtype, d,
                                                       entry):
    """The forward's partials go to the sm90 entry point of their dtype
    (bf16; fp32 through split TF32) with D padded to a multiple of 8 and
    the chunks of sm90_fwd_split; the combine launch merges them; one
    launch counted."""
    lib = _FwdRecorder()
    _stub_launch(monkeypatch, lib)
    n, v = 300, 1000
    x, w, lbl = (torch.from_numpy(a) for a in _data(n, d, v))
    torch_ce.reset_launches()
    nll, lse = torch_ce._launch(x.to(dtype), w.to(dtype), lbl)
    assert torch_ce.launches == 1 and nll.shape == lse.shape == (n,)
    names = [name for name, _ in lib.calls]
    assert names == [entry, "lmhead_ce_combine"]
    args = lib.calls[0][1]
    per, chunks = torch_ce.sm90_fwd_split(n, v, 132)
    assert args[6:11] == (n, 64, v, per, chunks)
    assert lib.calls[1][1][-2] == args[10]  # combine merges every chunk


def test_forward_raises_on_a_refused_launch(monkeypatch):
    """A refused tensor map (or any error code) raises with the code; no
    launch is counted and the plain version is never taken."""
    calls = []
    monkeypatch.setattr(torch_ce, "lmhead_ce_plain",
                        lambda *a: calls.append(a))
    lib = _FwdRecorder(err=-3)
    _stub_launch(monkeypatch, lib)
    x, w, lbl = (torch.from_numpy(a) for a in _data(40, 64, 300))
    torch_ce.reset_launches()
    with pytest.raises(RuntimeError, match="error -3.*tensor map refused"):
        torch_ce._launch(x.bfloat16(), w.bfloat16(), lbl)
    assert torch_ce.launches == 0 and calls == []
    assert [name for name, _ in lib.calls] == ["lmhead_ce_fwd_sm90"]


def test_fp32_forward_raises_on_a_refused_launch(monkeypatch):
    """A refused fp32 (split-TF32) launch raises with its code; no launch
    is counted, the plain version is not taken and no other entry point
    is tried."""
    calls = []
    monkeypatch.setattr(torch_ce, "lmhead_ce_plain",
                        lambda *a: calls.append(a))
    lib = _FwdRecorder(err=-3)
    _stub_launch(monkeypatch, lib)
    x, w, lbl = (torch.from_numpy(a) for a in _data(40, 64, 300))
    torch_ce.reset_launches()
    with pytest.raises(RuntimeError, match="lmhead_ce_fwd_f32_sm90.*error "
                                           "-3.*tensor map refused"):
        torch_ce._launch(x, w, lbl)
    assert torch_ce.launches == 0 and calls == []
    assert [name for name, _ in lib.calls] == ["lmhead_ce_fwd_f32_sm90"]


def test_build_key_follows_the_headers(monkeypatch, tmp_path):
    """The build directory's key hashes every *.cu and *.cuh under csrc/,
    so an edited header rebuilds instead of loading a stale library; only
    the *.cu files are compiled."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in _build.sources()] == ["a.cu"]
    assert [p.rsplit("/", 1)[1] for p in _build.headers()] == ["h.cuh"]
    key = _build._key()
    assert _build._key() == key
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = _build._key()
    assert edited != key
    (tmp_path / "b.cuh").write_text("// new\n")
    assert _build._key() not in (key, edited)


def test_ablation_tool_anchors_match_the_backward_kernel():
    """tools/torch_ce_bwd_ablation.py edits the bf16 backward's source by
    text; each of its anchors (the producer's loads, the two wgmma calls)
    must still be in the kernel, and each variant must differ from it."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_ce_bwd_ablation",
        os.path.join(root, "tools", "torch_ce_bwd_ablation.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(tool.SOURCE) as f:
        src = f.read()
    variants = tool.variants(src)
    assert variants["kernel"] == src
    assert all(text != src for name, text in variants.items()
               if name != "kernel")
