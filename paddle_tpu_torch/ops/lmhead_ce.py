"""Fused lm-head + softmax cross-entropy forward: the Hopper kernel's wrapper.

Port of the forward of ``paddle_tpu/ops/pallas/fused_lmhead_ce.py``
(``lmhead_ce`` -> ``_run_fwd`` -> ``_stats_kernel``). The kernel itself is
``paddle_tpu_torch/csrc/lmhead_ce.cu``: a split-vocab partial-stats launch
and a combine launch, counted as one kernel. Its source header states
what bounds it on the card and how the design answers that.

- :func:`lmhead_ce` -- per-token NLL of ``softmax(x2d @ w.T)`` at the
  labels, never materializing the [tokens, vocab] logits on the card;
- :func:`lmhead_ce_fwd` -- the same, also returning the per-row
  logsumexp the backward of a later training slice rebuilds from;
- :func:`lmhead_ce_plain` -- the plain PyTorch version (fp32 logits,
  ``logsumexp - picked``). The wrapper runs it for tensors on the CPU,
  and only there: a CUDA tensor launches the kernel or raises.

Labels outside ``[0, V)`` (negative ones included) pick nothing, so their
NLL is the logsumexp, as on the TPU. Inputs are fp32 or bf16; sums are
fp32 and fp32 inputs are multiplied in full fp32.

Forward only: the wrapper refuses inputs that require grad. The
autograd Function with the dx/dW kernels comes with training.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["lmhead_ce", "lmhead_ce_fwd", "lmhead_ce_plain", "launches",
           "reset_launches"]

# kernel launches made through the wrapper (the partial + combine pair
# counts once): the proof that a run went through the kernel
launches = 0

# vocab chunks per token block are sized for about this many blocks per
# SM, so that a 31-token score still spreads over the whole card
_BLOCKS_PER_SM = 4

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global launches
    launches = 0


def _check(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> None:
    if x2d.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(
            f"lmhead_ce takes x2d (N, D), w (V, D), labels (N,); got "
            f"{tuple(x2d.shape)}, {tuple(w.shape)}, {tuple(labels.shape)}")
    if x2d.shape[1] != w.shape[1] or x2d.shape[0] != labels.shape[0]:
        raise ValueError(
            f"lmhead_ce shape mismatch: x2d {tuple(x2d.shape)}, "
            f"w {tuple(w.shape)}, labels {tuple(labels.shape)}")
    if w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"lmhead_ce needs V >= 1 and D >= 1, got "
                         f"w {tuple(w.shape)}")
    if x2d.dtype not in _DTYPES or w.dtype != x2d.dtype:
        raise TypeError(
            f"lmhead_ce takes fp32 or bf16 x2d and w of one dtype; got "
            f"{x2d.dtype} and {w.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lmhead_ce labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if not (x2d.device == w.device == labels.device):
        raise ValueError(
            f"lmhead_ce inputs on different devices: {x2d.device}, "
            f"{w.device}, {labels.device}")
    if not (x2d.is_contiguous() and w.is_contiguous()
            and labels.is_contiguous()):
        raise ValueError("lmhead_ce takes contiguous tensors")
    if x2d.requires_grad or w.requires_grad:
        raise RuntimeError(
            "lmhead_ce is forward-only: its backward kernels come with "
            "training; call it on tensors that do not require grad")


def lmhead_ce_plain(x2d: torch.Tensor, w: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse), both (N,) fp32, from materialized fp32 logits."""
    logits = x2d.float() @ w.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    lbl = labels.long()
    hit = (lbl >= 0) & (lbl < w.shape[0])
    picked = torch.gather(logits, 1, lbl.clamp(0, w.shape[0] - 1)[:, None])
    picked = torch.where(hit, picked[:, 0], torch.zeros_like(lse))
    return lse - picked, lse


def split_vocab(n: int, v: int, tile_n: int, tile_v: int,
                sms: int) -> Tuple[int, int]:
    """(tiles_per_chunk, chunks): the vocab split of the partial launch,
    whose blocks cover ``tile_n`` rows and ``tile_v`` columns a step.
    Enough chunks that the (token blocks x chunks) grid gives each SM
    about ``_BLOCKS_PER_SM`` blocks, and no chunk starting past V."""
    tiles = -(-v // tile_v)
    token_blocks = -(-n // tile_n)
    chunks = max(1, min(tiles, -(-_BLOCKS_PER_SM * sms // token_blocks)))
    tiles_per_chunk = -(-tiles // chunks)
    return tiles_per_chunk, -(-tiles // tiles_per_chunk)


def _launch(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from . import _build

    lib = _build.load()
    n, d = x2d.shape
    v = w.shape[0]
    dev = x2d.device
    nll = torch.empty((n,), dtype=torch.float32, device=dev)
    lse = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return nll, lse
    lbl = labels.to(torch.int64).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles_per_chunk, chunks = split_vocab(
        n, v, lib.lmhead_ce_tile_n(), lib.lmhead_ce_tile_v(), sms)
    part = torch.empty((3, chunks, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lmhead_ce_partial(
        x2d.data_ptr(), w.data_ptr(), lbl.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), part[2].data_ptr(), n, d, v, tiles_per_chunk,
        chunks, int(x2d.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lmhead_ce_partial launch failed: CUDA error "
                           f"{err} (n={n}, d={d}, v={v}, chunks={chunks})")
    err = lib.lmhead_ce_combine(
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        nll.data_ptr(), lse.data_ptr(), n, chunks, stream)
    if err:
        raise RuntimeError(f"lmhead_ce_combine launch failed: CUDA error "
                           f"{err} (n={n}, chunks={chunks})")
    launches += 1
    return nll, lse


@torch.no_grad()
def lmhead_ce_fwd(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse), both (N,) fp32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise); other devices raise."""
    _check(x2d, w, labels)
    if x2d.device.type == "cpu":
        return lmhead_ce_plain(x2d, w, labels)
    if x2d.device.type != "cuda":
        raise ValueError(f"lmhead_ce runs on cuda or cpu, not {x2d.device}")
    with torch.cuda.device(x2d.device):
        return _launch(x2d, w, labels)


def lmhead_ce(x2d: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL (N,) fp32 of ``softmax(x2d @ w.T)`` at ``labels``.
    x2d: (N, D); w: (V, D), the tied-embedding layout; labels: (N,)."""
    return lmhead_ce_fwd(x2d, w, labels)[0]
