"""The port's fused lm-head + CE forward against the JAX package's.

The same numpy inputs go to ``paddle_tpu``'s pallas kernel (interpret
mode on the CPU, as its own tests run it) and to ``paddle_tpu_torch``'s
wrapper, which on CPU tensors runs its plain PyTorch version. The CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.

Tolerances: fp32 at rtol = atol = 1e-5, the JAX kernel's own bound
against materialized logits (only the summation order differs); bf16 at
2e-3, the floor of tests/test_fused_lmhead_ce.py (both sides multiply
bf16 inputs with fp32 accumulation).
"""
import numpy as np
import pytest

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
    with pytest.raises(RuntimeError, match="forward-only"):
        torch_ce.lmhead_ce(x.requires_grad_(), w, lbl)


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
