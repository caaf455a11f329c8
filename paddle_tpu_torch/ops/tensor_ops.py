"""Tensor creation and layout op lowerings.

Port of ``paddle_tpu/ops/tensor_ops.py``: ``fill_constant``,
``fill_zeros_like``, ``fill_any_like``, ``recompute_barrier``,
``assign``, ``assign_value``, ``cast``, ``reshape2``/``reshape``,
``transpose2``/``transpose``, ``slice``, ``squeeze2``/``squeeze``,
``unsqueeze2``/``unsqueeze``, ``flatten_contiguous_range``, ``concat``,
``split``, ``stack``, ``gather`` and ``one_hot``/``one_hot_v2``, with
the JAX package's
semantics (reshape's 0 copies the input dim, slice clamps its bounds,
squeeze drops only the listed axes of size 1).
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


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": x(ins).clone()}


@register_op("fill_any_like", stop_gradient=True)
def _fill_any_like(ctx, ins, attrs):
    v = x(ins)
    dtype = attrs.get("dtype", None)
    dt = v.dtype if dtype in (None, -1) else torch_dtype(dtype)
    return {"Out": torch.full_like(v, attrs.get("value", 0.0), dtype=dt)}


@register_op("squeeze2")
def _squeeze2(ctx, ins, attrs):
    v = x(ins)
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": v.squeeze()}
    keep = [d for i, d in enumerate(v.shape)
            if not (d == 1 and i in {a % v.dim() for a in axes})]
    return {"Out": v.reshape(keep)}


register_op("squeeze")(_squeeze2)


@register_op("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    v = x(ins)
    for a in sorted(attrs.get("axes", [])):
        v = v.unsqueeze(a)
    return {"Out": v}


register_op("unsqueeze")(_unsqueeze2)


@register_op("flatten_contiguous_range")
def _flatten_contiguous_range(ctx, ins, attrs):
    v = x(ins)
    start = attrs.get("start_axis", 1) % max(v.dim(), 1)
    stop = attrs.get("stop_axis", -1) % max(v.dim(), 1)
    return {"Out": v.reshape(tuple(v.shape[:start]) + (-1,)
                             + tuple(v.shape[stop + 1:]))}


@register_op("concat")
def _concat(ctx, ins, attrs):
    axis = int(maybe(ins, "AxisTensor", attrs.get("axis", 0)))
    return {"Out": torch.cat(ins["X"], dim=axis)}


@register_op("split")
def _split(ctx, ins, attrs):
    v = x(ins)
    axis = int(maybe(ins, "AxisTensor", attrs.get("axis", 0)))
    sections = list(attrs.get("sections", []))
    if sections:
        if -1 in sections:
            known = sum(s for s in sections if s > 0)
            sections[sections.index(-1)] = v.shape[axis] - known
        outs = torch.split(v, sections, dim=axis)
    else:
        outs = torch.chunk(v, attrs.get("num", 1), dim=axis)
    return {"Out": list(outs)}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("gather", no_grad_inputs=("Index",))
def _gather(ctx, ins, attrs):
    v, idx = ins["X"][0], ins["Index"][0]
    axis = int(maybe(ins, "Axis", attrs.get("axis", 0)))
    return {"Out": torch.index_select(v, axis, idx.reshape(-1).long())
            .reshape(tuple(v.shape[:axis]) + tuple(idx.shape)
                     + tuple(v.shape[axis + 1:]))}



@register_op("one_hot_v2", stop_gradient=True)
def _one_hot_v2(ctx, ins, attrs):
    """An index outside [0, depth) gives a row of zeros (``jax.nn.one_hot``;
    ``F.one_hot`` would raise)."""
    depth = int(maybe(ins, "depth_tensor", attrs.get("depth", 1)))
    idx = x(ins)
    if idx.dim() and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    classes = torch.arange(depth, device=idx.device)
    return {"Out": (idx.long().unsqueeze(-1) == classes).to(
        torch_dtype(attrs.get("dtype", "float32")))}


register_op("one_hot", stop_gradient=True)(_one_hot_v2)
