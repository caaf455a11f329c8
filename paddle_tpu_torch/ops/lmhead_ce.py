"""Fused lm-head + softmax cross-entropy: the Hopper kernels' wrappers.

Port of ``paddle_tpu/ops/pallas/fused_lmhead_ce.py`` (``lmhead_ce`` and
its custom VJP: ``_stats_kernel`` forward, ``_dx_kernel`` and
``_dw_kernel`` backward). The kernels are in
``paddle_tpu_torch/csrc/lmhead_ce_fwd_sm90.cu`` (bf16 forward on the
tensor cores), ``paddle_tpu_torch/csrc/lmhead_ce_fwd_f32_sm90.cu`` (fp32
forward on the tensor cores through split TF32),
``paddle_tpu_torch/csrc/lmhead_ce_bwd_sm90.cu`` (bf16 backward on the
tensor cores) and ``paddle_tpu_torch/csrc/lmhead_ce.cu`` (fp32 backward
on the FMA units, and the forward's combine launch), whose headers state
what bounds them on the card and how the design answers that:

- forward (``launches``): a split-vocab partial-stats launch and a
  combine launch, counted as one kernel. Both dtypes' partials are one
  wgmma launch over (128-row tiles x vocab chunks),
  :func:`sm90_fwd_blocks`. bf16 multiplies bf16 with fp32 sums; fp32
  writes each operand as hi + lo, two tf32 values (hi rounded to
  nearest, lo the rounded remainder), and sums three tf32 products a
  score (hi.hi + lo.hi + hi.lo): about 2^-22 of each product is dropped,
  so its scores are fp32-class (TF32 alone, 10 mantissa bits, would put
  about 1e-3 on a score). The serving path (``serving/model.py``) scores
  in fp32; training runs bf16;
- dx (``dx_launches``) and dW (``dw_launches``): in bf16 one wgmma
  launch over (row tiles x D halves), :func:`sm90_blocks`; in fp32 a
  SIMT launch over row tiles (dx at small N splits the vocabulary and
  adds a reduce launch, counted with it as one kernel).

Entry points:

- :func:`lmhead_ce` -- per-token NLL of ``softmax(x2d @ w.T)`` at the
  labels, differentiable in ``x2d`` and ``w`` through
  :class:`LmheadCE`, never materializing the [tokens, vocab] logits (or
  their gradient) on the card;
- :func:`lmhead_ce_fwd` -- the forward, also returning the per-row
  logsumexp the backward rebuilds the score tiles from;
- :func:`lmhead_ce_dx` / :func:`lmhead_ce_dw` -- dx and dW of
  ``sum(g * nll)`` from (x2d, w, labels, lse, g), one kernel each;
  :func:`lmhead_ce_bwd` returns both;
- :func:`lmhead_ce_plain`, :func:`lmhead_ce_dx_plain`,
  :func:`lmhead_ce_dw_plain` -- the plain PyTorch versions (materialized
  fp32 logits). A wrapper runs them for tensors on the CPU, and only
  there: a CUDA tensor launches the kernel or raises.

Labels outside ``[0, V)`` (negative ones included) pick nothing and hit
no column, as on the TPU. Inputs are fp32 or bf16; sums are fp32; the
backward rounds the d-logits to the inputs' dtype before the second
product, as the TPU kernels do. The tensor-core kernels read x and W
through TMA, which needs a row pitch of a multiple of 16 bytes: for a D
that is not a multiple of 8 the wrapper pads x and W with zero columns
into a copy (zero columns add nothing to any score or product) and
returns the first D columns. The forwards stream D, so they take any D;
the bf16 backward keeps the 64-row tile resident in shared memory, so
bf16 dx and dW take D up to 1024 and raise above it.

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
records a program's first run), by the JAX package's own estimates
(``fused_lmhead_ce.py:82-95``): 2NVD FLOPs for the forward, 4NVD for dx
and for dW, and each input read once and each output written once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..framework import xla_insight as _insight

__all__ = ["lmhead_ce", "lmhead_ce_fwd", "lmhead_ce_dx", "lmhead_ce_dw",
           "lmhead_ce_bwd", "lmhead_ce_plain", "lmhead_ce_dx_plain",
           "lmhead_ce_dw_plain", "LmheadCE", "launches", "dx_launches",
           "dw_launches", "reset_launches"]

# kernel launches made through the wrappers (a partial + combine/reduce
# pair counts once): the proof that a run went through the kernels
launches = 0      # forward (stats)
dx_launches = 0   # backward dx
dw_launches = 0   # backward dW

# split_vocab sizes the vocab chunks of a row block for about this many
# blocks per SM by default, so that a 31-token grid still spreads over the
# whole card
_BLOCKS_PER_SM = 4
# the fp32 backward's 64 x D shared-memory accumulator leaves room for
# one block per SM: two waves of blocks
_BWD_BLOCKS_PER_SM = 2
# the bf16 backward's row tile, D columns per block and per consumer
# warpgroup (csrc/lmhead_ce_bwd_sm90.cu)
SM90_TILE, SM90_HALF, SM90_SLAB = 64, 384, 192
# the forwards' token rows per block and vocab columns per tile, both
# dtypes (csrc/lmhead_ce_fwd_sm90.cu, csrc/lmhead_ce_fwd_f32_sm90.cu)
SM90_FWD_TILE_N, SM90_FWD_TILE_V = 128, 128
# their blocks run one per SM; their vocab chunks are sized for about this
# many blocks per SM over the launch, so that the last of several waves
# leaves little of the card idle
_SM90_FWD_BLOCKS_PER_SM = 8

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global launches, dx_launches, dw_launches
    launches = dx_launches = dw_launches = 0


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _note(name: str, products: int, x2d, w, labels, *rest) -> None:
    """One launch's cost to the program insight: ``products`` N x V x D
    products of 2 FLOPs, and the bytes of its operands ``x2d``, ``w``,
    ``labels`` and ``rest`` (the others it reads and what it writes)."""
    n, d = x2d.shape
    _insight.note_kernel(name, 2.0 * products * n * w.shape[0] * d,
                         _nbytes(x2d, w, labels, *rest))


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


def _check_bwd(x2d, w, labels, lse, g) -> None:
    _check(x2d, w, labels)
    n = x2d.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"lmhead_ce_bwd takes {name} as ({n},) fp32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"lmhead_ce_bwd: {name} must be contiguous on "
                             f"{x2d.device}")


def _device_route(x2d: torch.Tensor) -> str:
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lmhead_ce runs on cuda or cpu, not {x2d.device}")
    return x2d.device.type


# ---------------------------------------------------------------- plain


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


def _dlogits_plain(x2d, w, labels, lse, g) -> torch.Tensor:
    """fp32 d-logits ``(exp(s - lse) - onehot) * g``, rounded to W's
    dtype, from materialized fp32 logits."""
    logits = x2d.float() @ w.float().t()
    cols = torch.arange(w.shape[0], device=x2d.device)
    hit = (cols[None, :] == labels.long()[:, None]).float()
    dl = (torch.exp(logits - lse[:, None]) - hit) * g.float()[:, None]
    return dl.to(w.dtype).float()


def lmhead_ce_dx_plain(x2d, w, labels, lse, g) -> torch.Tensor:
    """dx (N, D) in x2d's dtype: d-logits . W in fp32, cast once."""
    return (_dlogits_plain(x2d, w, labels, lse, g) @ w.float()).to(x2d.dtype)


def lmhead_ce_dw_plain(x2d, w, labels, lse, g) -> torch.Tensor:
    """dW (V, D) in w's dtype: d-logits^T . x in fp32, cast once."""
    dl = _dlogits_plain(x2d, w, labels, lse, g)
    return (dl.t() @ x2d.float()).to(w.dtype)


# ---------------------------------------------------------------- kernels


def split_vocab(n: int, v: int, tile_n: int, tile_v: int, sms: int,
                blocks_per_sm: int = _BLOCKS_PER_SM) -> Tuple[int, int]:
    """(tiles_per_chunk, chunks): the column split of a launch whose
    blocks cover ``tile_n`` rows and sweep ``tile_v`` columns a step.
    Enough chunks that the (row blocks x chunks) grid gives each SM about
    ``blocks_per_sm`` blocks, and no chunk starting past the last column."""
    tiles = -(-v // tile_v)
    row_blocks = -(-n // tile_n)
    chunks = max(1, min(tiles, -(-blocks_per_sm * sms // row_blocks)))
    tiles_per_chunk = -(-tiles // chunks)
    return tiles_per_chunk, -(-tiles // tiles_per_chunk)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sm90_fwd_split(n: int, v: int, sms: int) -> Tuple[int, int]:
    """(tiles_per_chunk, chunks) of the forward's launch (both dtypes)."""
    return split_vocab(n, v, SM90_FWD_TILE_N, SM90_FWD_TILE_V, sms,
                       _SM90_FWD_BLOCKS_PER_SM)


def sm90_fwd_blocks(n: int, v: int, sms: int):
    """The forward's grid, in launch order (the row tile fastest):
    one entry per block, ``(rows, cols)``, each its [start, end) of token
    rows and of vocab columns (its chunk), clipped to N and V."""
    per, chunks = sm90_fwd_split(n, v, sms)
    width = per * SM90_FWD_TILE_V
    return [((i * SM90_FWD_TILE_N, min(n, (i + 1) * SM90_FWD_TILE_N)),
             (c * width, min(v, (c + 1) * width)))
            for c in range(chunks) for i in range(-(-n // SM90_FWD_TILE_N))]


def _aligned(*ts: torch.Tensor):
    """Each tensor, cloned where its pointer is not 16-byte aligned (TMA
    refuses it)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


# the forward's partial-stats entry point by dtype
_FWD_ENTRY = {torch.bfloat16: "lmhead_ce_fwd_sm90",
              torch.float32: "lmhead_ce_fwd_f32_sm90"}


def _partial_sm90(lib, x2d, w, lbl, sms, stream) -> torch.Tensor:
    """The partial stats [3, chunks, N] on the tensor cores (bf16, or fp32
    through split TF32)."""
    n, v = x2d.shape[0], w.shape[0]
    x2d, w = _aligned(*pad_d(x2d, w))
    per, chunks = sm90_fwd_split(n, v, sms)
    part = torch.empty((3, chunks, n), dtype=torch.float32,
                       device=x2d.device)
    entry = _FWD_ENTRY[x2d.dtype]
    err = getattr(lib, entry)(
        x2d.data_ptr(), w.data_ptr(), lbl.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), part[2].data_ptr(), n, x2d.shape[1], v, per,
        chunks, stream)
    if err:
        raise RuntimeError(
            f"lmhead_ce forward ({entry}) launch failed: error {err} (n={n}, "
            f"d={x2d.shape[1]}, v={v}, chunks={chunks}; -2: no "
            f"cuTensorMapEncodeTiled, -3: tensor map refused)")
    return part


def _launch(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from . import _build

    lib = _build.load()
    n = x2d.shape[0]
    dev = x2d.device
    nll = torch.empty((n,), dtype=torch.float32, device=dev)
    lse = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return nll, lse
    lbl = labels.to(torch.int64).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = _partial_sm90(lib, x2d, w, lbl, _sms(dev), stream)
    chunks = part.shape[1]
    err = lib.lmhead_ce_combine(
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        nll.data_ptr(), lse.data_ptr(), n, chunks, stream)
    if err:
        raise RuntimeError(f"lmhead_ce_combine launch failed: CUDA error "
                           f"{err} (n={n}, chunks={chunks})")
    launches += 1
    _note("lmhead_ce_fwd", 1, x2d, w, lbl, nll, lse)
    return nll, lse


def sm90_blocks(n_rows: int, d: int):
    """The bf16 backward's grid: one entry per block, ``(rows, slabs)``
    with ``rows`` its [start, end) of output rows and ``slabs`` the
    [start, end) output columns of its two consumer warpgroups, clipped
    to D (a slab past D is empty and its warpgroup stores nothing)."""
    blocks = []
    halves = -(-d // SM90_HALF)
    for i in range(-(-n_rows // SM90_TILE)):
        rows = (i * SM90_TILE, min(n_rows, (i + 1) * SM90_TILE))
        for h in range(halves):
            slabs = []
            for w in range(SM90_HALF // SM90_SLAB):
                lo = h * SM90_HALF + w * SM90_SLAB
                slabs.append((min(lo, d), min(lo + SM90_SLAB, d)))
            blocks.append((rows, tuple(slabs)))
    return blocks


def pad_d(*ts: torch.Tensor):
    """Each 2-D tensor with zero columns added up to a D that is a
    multiple of 8 (the same tensors where D already is one)."""
    d = ts[0].shape[1]
    extra = -d % 8
    if not extra:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, extra)) for t in ts)


def _launch_bwd_sm90(lib, a, b, lbl, g, lse, n_rows, n_cols,
                     token_rows: bool, stream) -> torch.Tensor:
    """One bf16 backward product on the tensor cores; returns out
    [n_rows, D] bf16. The kernel keeps the 64-row tile resident in shared
    memory, which bounds D (``lmhead_ce_sm90_max_d()``, 1024)."""
    d = a.shape[1]
    if d > lib.lmhead_ce_sm90_max_d():
        raise ValueError(f"lmhead_ce bf16 backward takes D <= "
                         f"{lib.lmhead_ce_sm90_max_d()}, got {d}")
    a, b = _aligned(*pad_d(a, b))
    out = torch.empty((n_rows, a.shape[1]), dtype=a.dtype, device=a.device)
    err = lib.lmhead_ce_bwd_sm90(
        a.data_ptr(), b.data_ptr(), lbl.data_ptr(), g.data_ptr(),
        lse.data_ptr(), out.data_ptr(), n_rows, n_cols, a.shape[1],
        int(token_rows), stream)
    if err:
        raise RuntimeError(
            f"lmhead_ce {'dx' if token_rows else 'dW'} (sm90) launch "
            f"failed: error {err} (rows={n_rows}, cols={n_cols}, d={d}; -2: "
            f"no cuTensorMapEncodeTiled, -3: tensor map refused)")
    return out if out.shape[1] == d else out[:, :d].contiguous()


def _launch_bwd_simt(lib, a, b, lbl, g, lse, n_rows, n_cols,
                     token_rows: bool, stream) -> torch.Tensor:
    """One fp32 backward product on the FMA units; returns out
    [n_rows, D] fp32."""
    d = a.shape[1]
    out = torch.empty((n_rows, d), dtype=a.dtype, device=a.device)
    tile = lib.lmhead_ce_tile_n()
    dslab = min(-(-d // 64) * 64, lib.lmhead_ce_bwd_max_slab())
    tiles_per_chunk, chunks = split_vocab(
        n_rows, n_cols, tile, tile, _sms(a.device), _BWD_BLOCKS_PER_SM)
    part = (torch.empty((chunks, n_rows, d), dtype=torch.float32,
                        device=a.device) if chunks > 1 else None)
    name = "dx" if token_rows else "dW"
    err = lib.lmhead_ce_bwd_partial(
        a.data_ptr(), b.data_ptr(), lbl.data_ptr(), g.data_ptr(),
        lse.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), n_rows, n_cols, d, tiles_per_chunk, chunks, dslab,
        int(token_rows), stream)
    if err:
        raise RuntimeError(
            f"lmhead_ce {name} launch failed: CUDA error {err} "
            f"(rows={n_rows}, cols={n_cols}, d={d}, chunks={chunks})")
    if part is not None:
        err = lib.lmhead_ce_bwd_reduce(part.data_ptr(), out.data_ptr(),
                                       n_rows * d, chunks, stream)
        if err:
            raise RuntimeError(f"lmhead_ce {name} reduce launch failed: "
                               f"CUDA error {err}")
    return out


def _launch_bwd_side(lib, a, b, lbl, g, lse, n_rows, n_cols,
                     token_rows: bool, stream) -> torch.Tensor:
    """One backward product (dx when the rows are tokens, dW when they
    are vocab entries): bf16 on the tensor cores, fp32 on the FMA
    units."""
    launch = (_launch_bwd_sm90 if a.dtype == torch.bfloat16
              else _launch_bwd_simt)
    return launch(lib, a, b, lbl, g, lse, n_rows, n_cols, token_rows,
                  stream)


def _launch_dx(x2d, w, labels, lse, g) -> torch.Tensor:
    global dx_launches
    from . import _build

    if not x2d.shape[0]:
        return torch.empty_like(x2d)
    dx = _launch_bwd_side(_build.load(), x2d, w, labels.to(torch.int64)
                          .contiguous(), g, lse, x2d.shape[0], w.shape[0],
                          True, torch.cuda.current_stream(x2d.device)
                          .cuda_stream)
    dx_launches += 1
    _note("lmhead_ce_dx", 2, x2d, w, labels, lse, g, dx)
    return dx


def _launch_dw(x2d, w, labels, lse, g) -> torch.Tensor:
    global dw_launches
    from . import _build

    if not x2d.shape[0]:
        return torch.zeros_like(w)
    dw = _launch_bwd_side(_build.load(), w, x2d, labels.to(torch.int64)
                          .contiguous(), g, lse, w.shape[0], x2d.shape[0],
                          False, torch.cuda.current_stream(x2d.device)
                          .cuda_stream)
    dw_launches += 1
    _note("lmhead_ce_dw", 2, x2d, w, labels, lse, g, dw)
    return dw


# ---------------------------------------------------------------- wrappers


@torch.no_grad()
def lmhead_ce_fwd(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse), both (N,) fp32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise); other devices raise."""
    _check(x2d, w, labels)
    if _device_route(x2d) == "cpu":
        return lmhead_ce_plain(x2d, w, labels)
    with torch.cuda.device(x2d.device):
        return _launch(x2d, w, labels)


def _bwd_wrapper(plain, kernel, x2d, w, labels, lse, g) -> torch.Tensor:
    _check_bwd(x2d, w, labels, lse, g)
    if _device_route(x2d) == "cpu":
        return plain(x2d, w, labels, lse, g)
    with torch.cuda.device(x2d.device):
        return kernel(x2d, w, labels, lse, g)


@torch.no_grad()
def lmhead_ce_dx(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx (N, D) of ``sum(g * nll)`` in x2d's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    return _bwd_wrapper(lmhead_ce_dx_plain, _launch_dx, x2d, w, labels, lse,
                        g)


@torch.no_grad()
def lmhead_ce_dw(x2d: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (V, D) of ``sum(g * nll)`` in w's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    return _bwd_wrapper(lmhead_ce_dw_plain, _launch_dw, x2d, w, labels, lse,
                        g)


def lmhead_ce_bwd(x2d, w, labels, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dW) of ``sum(g * nll)``."""
    return (lmhead_ce_dx(x2d, w, labels, lse, g),
            lmhead_ce_dw(x2d, w, labels, lse, g))


class LmheadCE(torch.autograd.Function):
    """``(nll, lse) = LmheadCE.apply(x2d, w, labels)``: the forward kernel,
    saving (x2d, w, labels, lse); the backward launches the dx and dW
    kernels with the incoming per-row cotangent of ``nll``. ``lse`` is
    not differentiable. Written with ``setup_context`` so that
    ``torch.func`` transforms can run it too."""

    @staticmethod
    def forward(x2d, w, labels):
        return lmhead_ce_fwd(x2d, w, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w, labels = inputs
        ctx.save_for_backward(x2d, w, labels, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        x2d, w, labels, lse = ctx.saved_tensors
        dx, dw = lmhead_ce_bwd(x2d, w, labels, lse,
                               g_nll.float().contiguous())
        return dx, dw, None


def lmhead_ce(x2d: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL (N,) fp32 of ``softmax(x2d @ w.T)`` at ``labels``.
    x2d: (N, D); w: (V, D), the tied-embedding layout; labels: (N,).
    Differentiable in x2d and w."""
    return LmheadCE.apply(x2d, w, labels)[0]
