"""Math op lowerings (the GPT training subset).

Port of ``paddle_tpu/ops/math_ops.py``: ``elementwise_add``, ``gelu``,
``scale``, ``matmul``/``matmul_v2``, ``mean`` and ``sum``. Large products
stay ``torch.matmul``, as they are plain ``jnp`` in the JAX package.
"""
from __future__ import annotations

import functools
import operator

import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .common import bcast_axis, maybe, x


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    return {"Out": xv + bcast_axis(xv, yv, attrs.get("axis", -1))}


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(x(ins), approximate=approximate)}


@register_op("scale")
def _scale(ctx, ins, attrs):
    scale = maybe(ins, "ScaleTensor", attrs.get("scale", 1.0))
    bias = attrs.get("bias", 0.0)
    v = x(ins)
    if attrs.get("bias_after_scale", True):
        out = v * scale + bias
    else:
        out = (v + bias) * scale
    return {"Out": out.to(v.dtype)}


@register_op("matmul_v2")
def _matmul_v2(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False) and xv.dim() > 1:
        xv = xv.transpose(-1, -2)
    if attrs.get("trans_y", False) and yv.dim() > 1:
        yv = yv.transpose(-1, -2)
    return {"Out": torch.matmul(xv, yv)}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and xv.dim() > 1:
        xv = xv.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and yv.dim() > 1:
        yv = yv.transpose(-1, -2)
    out = torch.matmul(xv, yv)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": torch.mean(x(ins))}


@register_op("sum")
def _sum(ctx, ins, attrs):
    return {"Out": functools.reduce(operator.add, ins["X"])}
