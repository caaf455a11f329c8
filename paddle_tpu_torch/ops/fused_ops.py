"""``fused_lm_head_ce``: tied lm head + softmax cross-entropy, fused.

Port of the ``fused_lm_head_ce`` rule of ``paddle_tpu/ops/fused_ops.py``:
X (B, T, D) against the tied embedding W (V, D) with labels (B, T[, 1])
gives the per-token loss (B, T, 1) fp32, without the [B, T, V] logits.

- ``impl="pallas"`` (the training default) runs the Hopper kernels of
  ``ops/lmhead_ce.py`` (forward, and dx / dW in the backward through its
  autograd Function); on CPU tensors their plain versions.
- ``impl="chunked"`` (the JAX package's lax-loop path, its A/B
  baseline): the tokens are padded up to a multiple of the chunk
  (``chunk_size``, 4096 by default; pad rows carry label 0 and are sliced
  off) and :class:`ChunkedLmHeadCE` runs the JAX package's custom VJP
  ``_lm_head_ce`` chunk by chunk: the forward takes an fp32 logsumexp of
  each chunk's logits, the backward recomputes each chunk's logits, so
  one [chunk, vocab] fp32 tile is live at a time in either direction.
  The products are plain ``x @ w.T`` matmuls of the stored values with
  fp32 results, as in the JAX package (no Pallas kernel there); the
  tape records the Function, whose own backward is the rule, never the
  chunk loop.
- The sharded plan of a mesh program waits for A10 (the executor refuses
  mesh programs).

The builder's ``"off"`` path never emits this op: it materializes logits
with ``matmul`` and takes ``softmax_with_cross_entropy``.

The op registers an ``infer=`` rule, so builder-time inference never
hands a meta tensor to the kernel wrapper.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op
from . import lmhead_ce as _ce


def _infer(op) -> None:
    x = op._input_vars["X"][0]
    for var in op._output_vars.get("Loss", []):
        var.shape = tuple(x.shape[:-1]) + (1,)
        var.dtype = "float32"


def lmhead_pad_and_chunks(n: int, chunk_size: int):
    """(padded_n, n_chunks): the token count padded UP to a multiple of
    the chunk, so one [C, V] tile bounds the working set for any n."""
    c = max(1, min(n, int(chunk_size)))
    padded = ((n + c - 1) // c) * c
    return padded, padded // c


def _chunk_logits(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # products of the stored values, fp32 results (the JAX package's
    # dot_general with preferred_element_type=float32)
    return xc.float() @ w.float().t()


class ChunkedLmHeadCE(torch.autograd.Function):
    """nll (N,) fp32 of the tied lm head + CE over ``n_chunks`` equal
    token chunks of x2d (N, D) against w (V, D) with labels (N,): the
    JAX package's ``_lm_head_ce`` custom VJP (``_lm_head_ce_fwd`` /
    ``_lm_head_ce_bwd``). The backward recomputes each chunk's logits and
    sums dW over the chunks in fp32."""

    @staticmethod
    def forward(x2d, w, lbl, n_chunks):
        n = x2d.shape[0]
        c = n // n_chunks
        out = []
        for i in range(n_chunks):
            logits = _chunk_logits(x2d[i * c:(i + 1) * c], w)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, lbl[i * c:(i + 1) * c].long()
                                   .unsqueeze(1))[:, 0]
            out.append(lse - picked)
        return torch.cat(out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w, lbl, n_chunks = inputs
        ctx.save_for_backward(x2d, w, lbl)
        ctx.n_chunks = n_chunks

    @staticmethod
    def backward(ctx, g):
        x2d, w, lbl = ctx.saved_tensors
        n, d = x2d.shape
        c = n // ctx.n_chunks
        dw = torch.zeros((w.shape[0], d), dtype=torch.float32,
                         device=w.device)
        dxs = []
        for i in range(ctx.n_chunks):
            xc = x2d[i * c:(i + 1) * c]
            lc = lbl[i * c:(i + 1) * c].long()
            logits = _chunk_logits(xc, w)  # recomputed
            p = torch.exp(logits - torch.logsumexp(logits, dim=-1,
                                                   keepdim=True))
            onehot = torch.zeros_like(p).scatter_(1, lc.unsqueeze(1), 1.0)
            dlog = ((p - onehot) * g[i * c:(i + 1) * c, None]).to(w.dtype)
            dxs.append((dlog.float() @ w.float()).to(x2d.dtype))
            dw += dlog.float().t() @ xc.float()
        return torch.cat(dxs), dw.to(w.dtype), None, None


def lmhead_ce_chunked(x2d: torch.Tensor, w: torch.Tensor, lbl: torch.Tensor,
                      chunk_size: int = 4096) -> torch.Tensor:
    """nll (N,) fp32 through :class:`ChunkedLmHeadCE`, the rows padded up
    to a multiple of the chunk (label 0, sliced off after)."""
    n, d = x2d.shape
    padded, n_chunks = lmhead_pad_and_chunks(n, chunk_size)
    if padded != n:
        x2d = torch.cat([x2d, x2d.new_zeros((padded - n, d))])
        lbl = torch.cat([lbl, lbl.new_zeros((padded - n,))])
    return ChunkedLmHeadCE.apply(x2d, w, lbl, n_chunks)[:n]


@register_op("fused_lm_head_ce", no_grad_inputs=("Label",), infer=_infer)
def _fused_lm_head_ce(ctx, ins, attrs):
    xv, w, lbl = ins["X"][0], ins["W"][0], ins["Label"][0]
    impl = str(attrs.get("impl", "chunked")).lower()
    if lbl.dim() == 3 and lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    b, t, d = xv.shape
    x2d, l1d = xv.reshape(b * t, d), lbl.reshape(b * t)
    if impl == "pallas":
        nll = _ce.lmhead_ce(x2d.contiguous(), w.contiguous(),
                            l1d.contiguous())
    else:
        nll = lmhead_ce_chunked(x2d, w, l1d, attrs.get("chunk_size", 4096))
    return {"Loss": nll.reshape(b, t, 1)}
