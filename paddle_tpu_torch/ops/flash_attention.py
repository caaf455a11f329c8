"""Flash attention: the Hopper kernels' wrappers.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
and its custom VJP: ``_fwd_kernel``/``_fwd_kernel_bthd`` forward,
``_bwd_dq_kernel``/``_bwd_dq_kernel_bthd`` and
``_bwd_dkv_kernel``/``_bwd_dkv_kernel_bthd`` backward). Every role, dtype
and head_dim runs a kernel on the tensor cores (``_SM90_ENTRIES``), in
``paddle_tpu_torch/csrc/``: ``flash_attention_fwd_sm90.cu`` and
``flash_attention_bwd_sm90.cu`` (bf16 at head_dim 64 and 128),
``flash_attention_fwd_d256_sm90.cu``, ``flash_attention_dq_d256_sm90.cu``
and ``flash_attention_dkv_d256_sm90.cu`` (bf16 at 256),
``flash_attention_fwd_f32_sm90.cu``, ``flash_attention_dq_f32_sm90.cu``
and ``flash_attention_dkv_f32_sm90.cu`` (fp32 at 64 and 128, split TF32),
``flash_attention_fwd_f32_d256_sm90.cu``,
``flash_attention_dq_f32_d256_sm90.cu`` and
``flash_attention_dkv_f32_d256_sm90.cu`` (fp32 at 256, split TF32),
whose headers state what bounds them on the card and how the design
answers that. One kernel per role, dtype and head_dim serves both
layouts, reading q, k, v and dO through rank-3 TMA tensor maps
(:func:`tma_geometry`; dO through q's):

- forward: out and the per-row logsumexp (``fwd_launches``): bf16
  ``flash_attn_fwd_sm90`` at 64 and 128, ``flash_attn_fwd_d256_sm90`` at
  256; fp32 ``flash_attn_fwd_f32_sm90`` at 64 and 128
  (``SM90_F32_FWD_TILES``), ``flash_attn_fwd_f32_d256_sm90`` at 256
  (``SM90_F32_D256_FWD_TILES``);
- dq (``dq_launches``): bf16 ``flash_attn_dq_sm90`` at 64 and 128,
  ``flash_attn_dq_d256_sm90`` at 256; fp32 ``flash_attn_dq_f32_sm90`` at
  64 and 128 (``SM90_F32_DQ_TILES``), ``flash_attn_dq_f32_d256_sm90`` at
  256 (``SM90_F32_D256_DQ_TILES``);
- dk and dv, one kernel (``dkv_launches``): bf16 ``flash_attn_dkv_sm90``
  at 64 and 128, ``flash_attn_dkv_d256_sm90`` at 256; fp32
  ``flash_attn_dkv_f32_sm90`` at 64 and 128 (``SM90_F32_DKV_TILES``),
  ``flash_attn_dkv_f32_d256_sm90`` at 256 (``SM90_F32_D256_DKV_TILES``).

Entry points:

- :func:`flash_attention` -- ``softmax(q k^T * scale) v``, causal or not,
  differentiable in q, k and v through :class:`FlashAttention`, never
  materializing the [Tq, Tk] scores (or their gradient) on the card;
- :func:`flash_attention_fwd` -- (out, lse), lse (B, H, Tq) fp32 in both
  layouts;
- :func:`flash_attention_dq` / :func:`flash_attention_dkv` -- dq and
  (dk, dv) from (q, k, v, dO, lse, delta), delta = rowsum(dO * out) from
  :func:`flash_attention_delta` (plain PyTorch, as the JAX package
  computes it outside its kernels);
- :func:`flash_attention_fwd_plain`, :func:`flash_attention_dq_plain`,
  :func:`flash_attention_dkv_plain` -- the plain PyTorch versions, which
  materialize the full fp32 score matrix. A wrapper runs them for
  tensors on the CPU, and only there: a CUDA tensor launches the kernel
  or raises.

The TPU tiling knobs (``block_q``, ``block_k``, ``interpret``,
``bwd_blocks``) have no counterpart: the kernels take any sequence
length, ragged tiles included.

Layouts: ``"BHTD"`` is (B, H, T, D), ``"BTHD"`` is (B, T, H, D); outputs
take the inputs' layout. Inputs are fp32 or bf16 of one dtype, D is 64,
128 or 256. The causal mask is aligned bottom-right: key c is visible
from query r iff ``c <= r + Tk - Tq``.

Rounding rule (one for both layouts): the scores are fp32 products of
the inputs times ``scale``; P is rounded to the inputs' dtype before
``P v`` and ``P^T dO``, dS = P (dP - delta) before ``dS k`` and
``dS^T q``; dq and dk are scaled once, in fp32, at the end (the fp32
dq and dk/dv scale each group of
``SM90_F32_BWD_FLUSH`` stage tiles' sum before adding it to the others':
at the default scale of head_dim 64 and 256, 1/8 and 1/16, the same
bits); every sum is fp32. The TPU's BHTD kernels round the same way; its BTHD kernels round
``q * scale`` to the inputs' dtype before the scores, which agrees where
the scale is a power of two (D = 64) and differs by one bf16 rounding of
q otherwise (D = 128, 256). The kernels' online softmax rounds P against
the running row max, the plain version rounds the normalized P, so in
bf16 the two differ by more than one ulp (``tests/test_flash_attention.py``
holds bf16 at 2e-2).

Masked scores take no part (the online softmax starts from -1e30, the
TPU's finite stand-in for -inf, and a masked entry contributes 0). A row
that sees no key at all (causal with Tq > Tk) gives out = 0 and
lse = -1e30, as the TPU kernel gives where such a row's whole block is
skipped.

Under a CUDA graph (``framework/replay.py``; the card's default for a
training step and the serving programs) the wrappers need nothing of
their own: they launch on ``torch.cuda.current_stream``, which is the
capture stream (a backward runs on its forward's stream), and allocate
outputs and scratch through torch, so both land in the graph's memory
pool. The TMA tensor maps are encoded on the host from the operands'
addresses when a launch is recorded and replayed as recorded; that is
safe only because the pool keeps every captured address fixed for the
graph's life. ``cudaFuncSetAttribute`` (a kernel's dynamic shared-memory
limit) runs at each launch, first in the eager warm-up before any
capture. The launch counters count Python calls: a capture adds one
call's launches, a replay none, although the graph relaunches the
recorded kernels.

Each launch also reports its analytic cost to the program insight
(``framework/xla_insight.note_kernel``; counted only while the executor
records a program's first run): 2 D FLOPs per visible score for each
product of the kernel's own algorithm (2 forward: scores, P V; 3 dq:
scores, dP, dS K; 4 dk/dv: scores, dP, P^T dO, dS^T Q), and each input
read once and each output written once.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..framework import xla_insight as _insight

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_delta", "tma_geometry",
           "flash_attention_fwd_plain", "flash_attention_dq_plain",
           "flash_attention_dkv_plain", "FlashAttention", "fwd_launches",
           "dq_launches", "dkv_launches", "reset_launches"]

# kernel launches made through the wrappers: the proof that a run went
# through the kernels
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_NEG = -1e30  # the TPU kernel's finite stand-in for -inf
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128, 256)
# the tensor-core entry point of each role by (dtype, head_dim)
_SM90_ENTRIES = {
    "fwd": {(torch.bfloat16, 64): "flash_attn_fwd_sm90",
            (torch.bfloat16, 128): "flash_attn_fwd_sm90",
            (torch.bfloat16, 256): "flash_attn_fwd_d256_sm90",
            (torch.float32, 64): "flash_attn_fwd_f32_sm90",
            (torch.float32, 128): "flash_attn_fwd_f32_sm90",
            (torch.float32, 256): "flash_attn_fwd_f32_d256_sm90"},
    "dq": {(torch.bfloat16, 64): "flash_attn_dq_sm90",
           (torch.bfloat16, 128): "flash_attn_dq_sm90",
           (torch.bfloat16, 256): "flash_attn_dq_d256_sm90",
           (torch.float32, 64): "flash_attn_dq_f32_sm90",
           (torch.float32, 128): "flash_attn_dq_f32_sm90",
           (torch.float32, 256): "flash_attn_dq_f32_d256_sm90"},
    "dkv": {(torch.bfloat16, 64): "flash_attn_dkv_sm90",
            (torch.bfloat16, 128): "flash_attn_dkv_sm90",
            (torch.bfloat16, 256): "flash_attn_dkv_d256_sm90",
            (torch.float32, 64): "flash_attn_dkv_f32_sm90",
            (torch.float32, 128): "flash_attn_dkv_f32_sm90",
            (torch.float32, 256): "flash_attn_dkv_f32_d256_sm90"},
}
# the bf16 forward's query rows per block and key/value rows per ring
# stage (csrc/flash_attention_fwd_sm90.cu; at head_dim 256
# csrc/flash_attention_fwd_d256_sm90.cu)
SM90_FWD_TILE_Q, SM90_FWD_TILE_KV = 128, 64
SM90_D256_FWD_TILES = (128, 64)
# the bf16 dk/dv's at head_dim 256: keys of a block, query rows of a ring
# stage (csrc/flash_attention_dkv_d256_sm90.cu)
SM90_D256_DKV_TILES = (64, 32)
# the bf16 dq's at head_dim 256: query rows of a block, keys of a ring
# stage (csrc/flash_attention_dq_d256_sm90.cu)
SM90_D256_DQ_TILES = (64, 32)
# the fp32 forward's, by head_dim (csrc/flash_attention_fwd_f32_sm90.cu):
# two consumer warpgroups of 64 query rows at D = 64, one at D = 128
SM90_F32_FWD_TILES = {64: (128, 32), 128: (64, 32)}
# and at head_dim 256 (csrc/flash_attention_fwd_f32_d256_sm90.cu): 64
# query rows a block, D split between its two warpgroups; 32 keys a tile
SM90_F32_D256_FWD_TILES = (64, 32)
# the fp32 backward's in split TF32: rows of a block's own tile (keys for
# dk/dv, csrc/flash_attention_dkv_f32_d256_sm90.cu at head_dim 256 and
# csrc/flash_attention_dkv_f32_sm90.cu at 64 and 128; query rows for dq,
# csrc/flash_attention_dq_f32_d256_sm90.cu at 256 and
# csrc/flash_attention_dq_f32_sm90.cu at 64 and 128, 64 a warpgroup) and
# of a stage tile of the other side, and the stage tiles whose products
# one accumulator of the tensor cores sums before the sum is added, in
# fp32, into the output (counted from row 0)
SM90_F32_D256_DKV_TILES = (64, 16)
SM90_F32_D256_DQ_TILES = (64, 16)
SM90_F32_DKV_TILES = (64, 16)
SM90_F32_DQ_TILES = (128, 16)
SM90_F32_BWD_FLUSH = 8
# the bf16 backward's, by head_dim (csrc/flash_attention_bwd_sm90.cu):
# rows of a block's own tile (query rows for dq, keys for dk/dv), key
# rows of a dq ring stage, query rows of a dk/dv ring stage
SM90_BWD_TILES = {64: (128, 64, 32), 128: (64, 64, 32)}
_LAYOUTS = ("BHTD", "BTHD")


def reset_launches() -> None:
    global fwd_launches, dq_launches, dkv_launches
    fwd_launches = dq_launches = dkv_launches = 0


def visible_scores(tq: int, tk: int, causal: bool) -> int:
    """Scores a (batch, head) computes: all Tq x Tk, or, with the causal
    mask aligned bottom-right, Tk - Tq + i + 1 (at least 0) in row i:
    the sum of m .. Tk for m = max(1, Tk - Tq + 1)."""
    if not causal:
        return tq * tk
    if not tq or not tk:
        return 0
    m = max(1, tk - tq + 1)
    return (tk * (tk + 1) - (m - 1) * m) // 2


def _note(name: str, products: int, q, k, layout, causal, *operands):
    if not _insight.active():
        return
    b, h, tq, tk, d = _dims(q, k, layout)
    _insight.note_kernel(
        name, 2.0 * d * products * b * h * visible_scores(tq, tk, causal),
        sum(t.numel() * t.element_size() for t in operands))


def _dims(q: torch.Tensor, k: torch.Tensor, layout: str):
    """(B, H, Tq, Tk, D)."""
    if layout == "BTHD":
        return q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3]
    return q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(f"flash_attention layout must be one of {_LAYOUTS}, "
                         f"got {layout!r}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes 4-D q, k and v with v shaped as k; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, _, d = _dims(q, k, layout)
    bk, hk, _, _, dk = _dims(k, k, layout)
    if (b, h, d) != (bk, hk, dk):
        raise ValueError(
            f"flash_attention ({layout}): q {tuple(q.shape)} and k "
            f"{tuple(k.shape)} differ in batch, heads or head_dim")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes fp32 or bf16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernels take contiguous tensors")


def _check_bwd(q, k, v, dout, lse, delta, layout) -> None:
    _check(q, k, v, layout)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward takes dout as q "
                         f"({tuple(q.shape)} {q.dtype}), got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    b, h, tq, _, _ = _dims(q, k, layout)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention backward takes {name} as "
                             f"({b}, {h}, {tq}) fp32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("dout", dout), ("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous on {q.device}")


def _device_route(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


# ---------------------------------------------------------------- plain


def _heads_first(t: torch.Tensor, layout: str) -> torch.Tensor:
    """(B, H, T, D) fp32."""
    return (t.transpose(1, 2) if layout == "BTHD" else t).float()


def _to_layout(t: torch.Tensor, layout: str, dtype) -> torch.Tensor:
    """(B, H, T, D) fp32 -> the layout, cast once."""
    return (t.transpose(1, 2) if layout == "BTHD" else t).to(dtype) \
        .contiguous()


def _masked(s: torch.Tensor, causal: bool, fill: float) -> torch.Tensor:
    """s (.., Tq, Tk) with ``fill`` where the bottom-right causal mask
    hides a key."""
    if not causal:
        return s
    tq, tk = s.shape[-2:]
    keep = torch.ones((tq, tk), dtype=torch.bool,
                      device=s.device).tril(tk - tq)
    return s.masked_fill(~keep, fill)


def _probs_plain(q, k, lse, causal, scale, layout) -> torch.Tensor:
    """P = exp(s - lse), 0 where masked, (B, H, Tq, Tk) fp32: the scores
    rebuilt from the saved lse, as the backward kernels rebuild them."""
    s = _heads_first(q, layout) @ _heads_first(k, layout).transpose(-1, -2)
    return _masked(torch.exp(s * scale - lse[..., None]), causal, 0.0)


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None,
                              layout="BHTD"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) from the materialized fp32 scores: out in q's layout and
    dtype, lse (B, H, Tq) fp32 (-1e30 for a row that sees no key)."""
    scale = _scale(scale, q.shape[-1])
    s = _masked((_heads_first(q, layout)
                 @ _heads_first(k, layout).transpose(-1, -2)) * scale,
                causal, float("-inf"))
    lse = torch.logsumexp(s, dim=-1).clamp_min(_NEG)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    out = p @ _heads_first(v, layout)
    return _to_layout(out, layout, q.dtype), lse.contiguous()


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor,
                          layout: str = "BHTD") -> torch.Tensor:
    """delta = rowsum(dO * out), (B, H, Tq) fp32."""
    delta = (dout.float() * out.float()).sum(-1)
    return (delta.transpose(1, 2) if layout == "BTHD" else delta) \
        .contiguous()


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal=False,
                             scale=None, layout="BHTD") -> torch.Tensor:
    """dq in q's layout and dtype: scale * round(P (dP - delta)) k."""
    scale = _scale(scale, q.shape[-1])
    p = _probs_plain(q, k, lse, causal, scale, layout)
    dp = _heads_first(dout, layout) @ _heads_first(v, layout) \
        .transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return _to_layout((ds @ _heads_first(k, layout)) * scale, layout,
                      q.dtype)


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal=False,
                              scale=None, layout="BHTD"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's layout and dtype: dk = scale * round(dS)^T q,
    dv = round(P)^T dO."""
    scale = _scale(scale, q.shape[-1])
    p = _probs_plain(q, k, lse, causal, scale, layout)
    do = _heads_first(dout, layout)
    dp = do @ _heads_first(v, layout).transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dv = p.to(q.dtype).float().transpose(-1, -2) @ do
    dk = (ds.transpose(-1, -2) @ _heads_first(q, layout)) * scale
    return _to_layout(dk, layout, q.dtype), _to_layout(dv, layout, q.dtype)


# ---------------------------------------------------------------- kernels


def tma_geometry(t: torch.Tensor, layout: str) -> Tuple[int, ...]:
    """How the tensor-core kernels address a contiguous q, k or v through
    a rank-3 TMA tensor map: ``(inner, outer, st_seq, st_outer, head_col,
    outer_b, outer_h)``, in elements. The map's dimensions are (inner,
    T, outer), strided st_seq and st_outer; element (b, t, h, c) sits at
    coordinates (h * head_col + c, t, b * outer_b + h * outer_h). BTHD:
    (H*D, T, B), a head a column offset; BHTD: (D, T, B*H). T is a
    dimension of its own, so a box past a sequence's end reads TMA's
    zero fill, never the next batch's or head's rows."""
    s = t.stride()
    if layout == "BTHD":
        b, _, h, d = t.shape
        return (h * d, b, s[1], s[0], s[2], 1, 0)
    b, h, _, d = t.shape
    return (d, b * h, s[2], s[1], 0, h, 1)


def _tensor_cores(q: torch.Tensor, role: str) -> str:
    """The tensor-core entry point that takes ``role`` ("fwd", "dq" or
    "dkv") of q's dtype and head_dim: every role has one at every dtype
    and head_dim that ``_check`` lets through."""
    return _SM90_ENTRIES[role][(q.dtype, q.shape[-1])]


def _launch_fwd_sm90(lib, entry, q, k, v, causal, scale, layout):
    """The forward on the tensor cores through ``entry``: bf16 through
    ``flash_attn_fwd_sm90`` (head_dim 64, 128) or
    ``flash_attn_fwd_d256_sm90``, fp32 through ``flash_attn_fwd_f32_sm90``
    or ``flash_attn_fwd_f32_d256_sm90`` (split TF32); all take the same
    rank-3 tensor maps."""
    b, h, tq, tk, d = _dims(q, k, layout)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    geo = [(ctypes.c_longlong * 7)(*tma_geometry(t, layout)) for t in (q, k)]
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, tq, tk, d, *geo, scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash attention forward ({entry}) launch failed: error {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {layout}; -2: no "
            f"cuTensorMapEncodeTiled, -3: tensor map refused)")
    return out, lse


def _launch_fwd(q, k, v, causal, scale, layout):
    global fwd_launches
    from . import _build

    out, lse = _launch_fwd_sm90(_build.load(), _tensor_cores(q, "fwd"), q, k,
                                v, causal, scale, layout)
    fwd_launches += 1
    _note("flash_attention_fwd", 2, q, k, layout, causal, q, k, v, out, lse)
    return out, lse


def _launch_bwd(role, what, outs, q, k, v, dout, lse, delta, causal, scale,
                layout):
    """The dq or dk/dv kernel (``role`` "dq" or "dkv", its tensor-core
    entry point ``_tensor_cores``) writes ``outs``, reading q, k, v and dO
    through rank-3 tensor maps (dO through q's geometry)."""
    from . import _build

    entry = _tensor_cores(q, role)
    b, h, tq, tk, d = _dims(q, k, layout)
    q, k, v, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (q, k, v, dout))
    geo = [(ctypes.c_longlong * 7)(*tma_geometry(t, layout)) for t in (q, k)]
    dims = (b, h, tq, tk, d, *geo, scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    err = getattr(_build.load(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        *dims)
    if err:
        raise RuntimeError(
            f"flash attention {what} launch ({entry}) failed: error {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {layout}, {q.dtype}; "
            f"-2: no cuTensorMapEncodeTiled, -3: tensor map refused)")


def _launch_dq(q, k, v, dout, lse, delta, causal, scale, layout):
    global dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("dq", "dq", (dq,), q, k, v, dout, lse, delta,
                causal, scale, layout)
    dq_launches += 1
    _note("flash_attention_dq", 3, q, k, layout, causal, q, k, v, dout, lse,
          delta, dq)
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, causal, scale, layout):
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", "dk/dv", (dk, dv), q, k, v, dout, lse,
                delta, causal, scale, layout)
    dkv_launches += 1
    _note("flash_attention_dkv", 4, q, k, layout, causal, q, k, v, dout, lse,
          delta, dk, dv)
    return dk, dv


# ---------------------------------------------------------------- wrappers


@torch.no_grad()
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        layout: str = "BHTD"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): out in q's layout and dtype, lse (B, H, Tq) fp32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise); other devices raise."""
    _check(q, k, v, layout)
    scale = _scale(scale, q.shape[-1])
    if _device_route(q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale, layout)
    with torch.cuda.device(q.device):
        return _launch_fwd(q, k, v, bool(causal), scale, layout)


def _bwd_wrapper(plain, kernel, q, k, v, dout, lse, delta, causal, scale,
                 layout):
    _check_bwd(q, k, v, dout, lse, delta, layout)
    scale = _scale(scale, q.shape[-1])
    if _device_route(q) == "cpu":
        return plain(q, k, v, dout, lse, delta, causal, scale, layout)
    with torch.cuda.device(q.device):
        return kernel(q, k, v, dout, lse, delta, bool(causal), scale, layout)


@torch.no_grad()
def flash_attention_dq(q, k, v, dout, lse, delta, causal=False, scale=None,
                       layout="BHTD") -> torch.Tensor:
    """dq in q's layout and dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    return _bwd_wrapper(flash_attention_dq_plain, _launch_dq, q, k, v, dout,
                        lse, delta, causal, scale, layout)


@torch.no_grad()
def flash_attention_dkv(q, k, v, dout, lse, delta, causal=False, scale=None,
                        layout="BHTD") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's layout and dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    return _bwd_wrapper(flash_attention_dkv_plain, _launch_dkv, q, k, v,
                        dout, lse, delta, causal, scale, layout)


class FlashAttention(torch.autograd.Function):
    """``(out, lse) = FlashAttention.apply(q, k, v, causal, scale,
    layout)``: the forward kernel, saving (q, k, v, out, lse); the
    backward computes delta and launches the dq and dk/dv kernels with
    the incoming cotangent of ``out``. ``lse`` is not differentiable.
    Written with ``setup_context`` so that ``torch.func`` transforms can
    run it too."""

    @staticmethod
    def forward(q, k, v, causal, scale, layout):
        return flash_attention_fwd(q, k, v, causal, scale, layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale, layout = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.layout = causal, scale, layout
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = g_out.to(q.dtype).contiguous()
        delta = flash_attention_delta(out, dout, ctx.layout)
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.scale, ctx.layout)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    layout: str = "BHTD") -> torch.Tensor:
    """Flash attention. q, k, v: (B, H, T, D) for layout 'BHTD' or
    (B, T, H, D) for 'BTHD'; the output matches the input layout.
    Differentiable in q, k and v."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return FlashAttention.apply(q, k, v, bool(causal),
                                _scale(scale, q.shape[-1]), layout)[0]
