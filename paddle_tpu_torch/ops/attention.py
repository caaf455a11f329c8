"""``fused_attention_tpu``: attention as the JAX package dispatches it.

Port of ``paddle_tpu/ops/attention.py``. The op takes the flash kernels
(``ops/flash_attention.py``, hand-written CUDA; ``PERF.md`` rows 4-6)
wherever the JAX op takes its pallas flash path, and nowhere else: no
mask, sequence length >= ``PADDLE_TPU_FLASH_MIN_SEQ`` (1024), head_dim in
{64, 128, 256}, and the JAX op's block candidates dividing both sequence
lengths (:func:`_flash_would_run`). ``FLASH_DISPATCH_COUNT`` counts those
dispatches, as the JAX op's counter does (``bench.py`` asserts that the
long-sequence config took flash). Otherwise the op computes the JAX
package's ``_sdpa_xla`` in plain PyTorch: two einsums around an fp32
softmax, the causal mask ``tril(ones(tq, tk), tk - tq)`` applied as
``-inf``, in either layout (BTHD = (B, T, H, D), BHTD = (B, H, T, D)).
It is not ``F.scaled_dot_product_attention``: the reference computes it
with einsums.

``PADDLE_TPU_DISABLE_FLASH`` keeps its meaning: take the einsum path.
There is no fallback from flash to einsum: the JAX op falls back where
pallas is unavailable on its backend, which has no counterpart here, so
a kernel that fails to build or launch raises. Ring attention (a
``sequence_parallel_axis``) raises: the port has no device mesh yet.

Dropout (``dropout_p`` > 0, not ``is_test``) keeps an element where the
lowering context's counter-based draw (``LoweringContext.uniform``: the
step's seed and step tensor on the device, the op's ``_rng_id``, the
element's index) is below ``1 - p``, and scales it by ``1 / (1 - p)``, as
the JAX op does; a recomputed clone of the op draws the same mask.

The op registers an ``infer=`` rule, so builder-time inference never
hands a meta tensor to a kernel wrapper.
"""
from __future__ import annotations

import math
import os

import torch

from ..framework import errors as _errs
from ..framework.registry import register_op
from .common import maybe
from .flash_attention import flash_attention

# fused_attention_tpu runs that dispatched to the flash kernels
FLASH_DISPATCH_COUNT = 0


def _sdpa_einsum(q, k, v, mask=None, is_causal=False, scale=None,
                 layout="BHTD"):
    """Einsum attention with an fp32 softmax (``_sdpa_xla`` of the JAX
    package)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qk = "bqhd,bkhd->bhqk" if layout == "BTHD" else "bhqd,bhkd->bhqk"
    pv = "bhqk,bkhd->bqhd" if layout == "BTHD" else "bhqk,bhkd->bhqd"
    logits = torch.einsum(qk, q, k).float() * scale
    if is_causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((tq, tk), dtype=torch.bool,
                            device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum(pv, probs, v)


def _flash_would_run(q, k, layout: str) -> bool:
    """The JAX op's condition for its pallas flash path."""
    min_seq = int(os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ", 1024))
    seq_ax = 1 if layout == "BTHD" else 2
    tq, tk = q.shape[seq_ax], k.shape[seq_ax]
    if tq < min_seq or q.shape[-1] not in (64, 128, 256):
        return False
    blocks = os.environ.get("PADDLE_TPU_FLASH_BLOCKS")
    if blocks:
        qs, _, ks = blocks.partition(";")
        cand_q = tuple(int(b) for b in qs.split(","))
        cand_k = tuple(int(b) for b in (ks or qs).split(","))
    else:
        cand_q = (256, 128) if layout == "BTHD" else (512, 256, 128)
        cand_k = (512, 256, 128) if layout == "BTHD" else (1024, 512, 256,
                                                           128)
    return (any(tq % b == 0 for b in cand_q)
            and any(tk % b == 0 for b in cand_k))


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """The functional entry of ``nn.functional``: one
    ``fused_attention_tpu`` op through ``ops.api.dispatch``, so the eager
    tracer records it and a static program appends it."""
    from .api import dispatch

    ins = {"Q": q, "K": k, "V": v}
    if attn_mask is not None:
        ins["Mask"] = attn_mask
    return dispatch("fused_attention_tpu", ins,
                    {"dropout_p": float(dropout_p),
                     "is_causal": bool(is_causal), "is_test": not training},
                    ("Out",))


def _infer(op) -> None:
    q, v = op._input_vars["Q"][0], op._input_vars["V"][0]
    for var in op._output_vars.get("Out", []):
        var.shape = tuple(q.shape[:-1]) + (v.shape[-1],)
        var.dtype = q.dtype


@register_op("fused_attention_tpu", no_grad_inputs=("Mask",), uses_rng=True,
             infer=_infer)
def _fused_attention_tpu(ctx, ins, attrs):
    global FLASH_DISPATCH_COUNT
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = maybe(ins, "Mask")
    is_causal = attrs.get("is_causal", False)
    layout = attrs.get("layout", "BHTD")
    if attrs.get("sequence_parallel_axis", ""):
        raise _errs.errors.Unimplemented(
            "ring attention (a sequence_parallel_axis) needs a device mesh, "
            "which paddle_tpu_torch does not have yet (ROADMAP.md queue A, "
            "item A10)")
    use_flash = (attrs.get("use_flash", True)
                 and not os.environ.get("PADDLE_TPU_DISABLE_FLASH"))
    if use_flash and mask is None and _flash_would_run(q, k, layout):
        out = flash_attention(q, k, v, causal=is_causal, layout=layout)
        FLASH_DISPATCH_COUNT += 1
    else:
        out = _sdpa_einsum(q, k, v, mask, is_causal, layout=layout)
    p = attrs.get("dropout_p", 0.0)
    if p and not attrs.get("is_test", False):
        keep = ctx.uniform(attrs.get("_rng_id", 0), out.shape) < (1.0 - p)
        out = torch.where(keep, out / (1.0 - p),
                          torch.zeros_like(out)).to(out.dtype)
    return {"Out": out}
