"""Tensor creation and layout op lowerings (the GPT training subset).

Port of ``paddle_tpu/ops/tensor_ops.py``: ``fill_constant``,
``fill_zeros_like``, ``recompute_barrier``, ``assign_value``, ``cast``,
``reshape2``/``reshape``, ``transpose2``/``transpose`` and ``slice``,
with the JAX package's semantics (reshape's 0 copies the input dim,
slice clamps its bounds).
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import maybe, torch_dtype, x


@register_op("fill_constant", stop_gradient=True)
def _fill_constant(ctx, ins, attrs):
    shape = maybe(ins, "ShapeTensor", attrs.get("shape", []))
    if isinstance(shape, torch.Tensor):
        shape = [int(d) for d in shape.tolist()]
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    value = maybe(ins, "ValueTensor", attrs.get("value", 0.0))
    if isinstance(value, torch.Tensor):
        return {"Out": value.to(dtype).expand(tuple(int(d) for d in shape))
                .clone()}
    return {"Out": torch.full(tuple(int(d) for d in shape), value,
                              dtype=dtype, device=ctx.device)}


@register_op("fill_zeros_like", stop_gradient=True)
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(x(ins))}


@register_op("recompute_barrier", stop_gradient=True, no_grad_inputs=("Dep",))
def _recompute_barrier(ctx, ins, attrs):
    """The identity on X (``append_backward_with_checkpoints`` reads every
    input of a recomputed segment through it). In the JAX package it is an
    optimization barrier that keeps XLA from merging the recomputed clones
    with the forward and orders them after the ``Dep`` cotangent; the
    port's executor runs ops in program order and merges nothing, so X
    passes as it is. ``Dep`` is still an input of the op, so the program's
    op order and the values' lifetimes (``executor.liveness``) are the
    desc's."""
    return {"Out": x(ins)}


@register_op("assign_value", stop_gradient=True)
def _assign_value(ctx, ins, attrs):
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    shape = attrs.get("shape", [])
    for key in ("fp32_values", "fp64_values", "int32_values",
                "int64_values", "bool_values"):
        vals = attrs.get(key)
        if vals:
            return {"Out": torch.tensor(vals, dtype=dtype,
                                        device=ctx.device).reshape(shape)}
    return {"Out": torch.zeros(shape, dtype=dtype, device=ctx.device)}


@register_op("cast")
def _cast(ctx, ins, attrs):
    dtype = torch_dtype(attrs.get("out_dtype", attrs.get("dtype", "float32")))
    return {"Out": x(ins).to(dtype)}


def _resolve_shape(v, shape):
    """Reshape semantics of the JAX package: 0 copies the input dim, -1
    infers."""
    shape = list(shape)
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = v.shape[i]
    return shape


@register_op("reshape2")
def _reshape2(ctx, ins, attrs):
    v = x(ins)
    shape = maybe(ins, "ShapeTensor", attrs.get("shape", []))
    if isinstance(shape, torch.Tensor):
        shape = [int(d) for d in shape.tolist()]
    return {"Out": v.reshape(_resolve_shape(v, shape))}


register_op("reshape")(_reshape2)


@register_op("transpose2")
def _transpose2(ctx, ins, attrs):
    v = x(ins)
    perm = attrs.get("axis", None)
    if perm is None:
        perm = list(reversed(range(v.dim())))
    return {"Out": v.permute(*perm)}


register_op("transpose")(_transpose2)


@register_op("slice")
def _slice(ctx, ins, attrs):
    v = x(ins, "Input")
    idx = [slice(None)] * v.dim()
    for a, s, e in zip(attrs.get("axes", []), attrs.get("starts", []),
                       attrs.get("ends", [])):
        dim = v.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = v[tuple(idx)]
    decrease = attrs.get("decrease_axis", [])
    if decrease:
        keep = [d for i, d in enumerate(out.shape) if i not in set(decrease)]
        out = out.reshape(keep)
    return {"Out": out}
