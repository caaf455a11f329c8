"""``fused_lm_head_ce``: tied lm head + softmax cross-entropy, fused.

Port of the ``fused_lm_head_ce`` rule of ``paddle_tpu/ops/fused_ops.py``:
X (B, T, D) against the tied embedding W (V, D) with labels (B, T[, 1])
gives the per-token loss (B, T, 1) fp32, without the [B, T, V] logits.

- ``impl="pallas"`` (the training default) runs the Hopper kernels of
  ``ops/lmhead_ce.py`` (forward, and dx / dW in the backward through its
  autograd Function); on CPU tensors their plain versions.
- ``impl="chunked"`` (the JAX package's lax-loop path) is not ported
  and raises; so is the sharded plan of a mesh program (the executor
  refuses mesh programs).

The builder's ``"off"`` path never emits this op: it materializes logits
with ``matmul`` and takes ``softmax_with_cross_entropy``.

The op registers an ``infer=`` rule, so builder-time inference never
hands a meta tensor to the kernel wrapper.
"""
from __future__ import annotations

from ..framework import errors as _errs
from ..framework.registry import register_op
from . import lmhead_ce as _ce


def _infer(op) -> None:
    x = op._input_vars["X"][0]
    for var in op._output_vars.get("Loss", []):
        var.shape = tuple(x.shape[:-1]) + (1,)
        var.dtype = "float32"


@register_op("fused_lm_head_ce", no_grad_inputs=("Label",), infer=_infer)
def _fused_lm_head_ce(ctx, ins, attrs):
    xv, w, lbl = ins["X"][0], ins["W"][0], ins["Label"][0]
    impl = str(attrs.get("impl", "chunked")).lower()
    if impl != "pallas":
        raise _errs.errors.Unimplemented(
            f"fused_lm_head_ce impl={impl!r} (the lax-loop chunked path) is "
            f"not ported (ROADMAP.md queue A, item A3); impl='pallas' runs "
            f"the fused kernels, and the builder's 'off' path needs no "
            f"fused op")
    if lbl.dim() == 3 and lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    b, t, d = xv.shape
    nll = _ce.lmhead_ce(xv.reshape(b * t, d).contiguous(), w.contiguous(),
                        lbl.reshape(b * t).contiguous())
    return {"Loss": nll.reshape(b, t, 1)}
