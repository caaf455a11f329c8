"""Math op lowerings (the GPT training subset).

Port of ``paddle_tpu/ops/math_ops.py``: ``elementwise_add``, ``_mul``,
``_div`` and ``_max``, ``gelu``, ``sqrt``, ``sign``, ``scale``, ``clip``,
``matmul``/``matmul_v2``, ``mean``, ``sum``, ``clip_by_norm`` and
``squared_l2_norm`` (the last two and the binaries are what gradient
clipping and weight decay append). Large products stay
``torch.matmul``, as they are plain ``jnp`` in the JAX package.

Dtypes follow the JAX package's rules, not torch's: a binary op computes
in the promotion of its two operands' dtypes whatever their ranks (bf16
times a 0-d fp32 tensor is fp32, as in ``jnp``; torch would keep bf16),
and a reduction returns its input's dtype (``squared_l2_norm`` of a bf16
gradient is bf16; ``sum`` adds its inputs one after another in their
dtype).
"""
from __future__ import annotations

import functools
import operator

import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .common import bcast_axis, maybe, x


def _binary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        xv, yv = ins["X"][0], ins["Y"][0]
        yv = bcast_axis(xv, yv, attrs.get("axis", -1))
        dt = torch.promote_types(xv.dtype, yv.dtype)
        return {"Out": _fn(xv.to(dt), yv.to(dt))}

    return _lower


_binary("elementwise_add", torch.add)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)


def _unary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(x(ins))}

    return _lower


_unary("sqrt", torch.sqrt)
_unary("sign", torch.sign)


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


@register_op("clip")
def _clip(ctx, ins, attrs):
    lo = maybe(ins, "Min", attrs.get("min", float("-inf")))
    hi = maybe(ins, "Max", attrs.get("max", float("inf")))
    return {"Out": torch.clamp(x(ins), lo, hi)}


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


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    v = x(ins)
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(v)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": v * scale.to(v.dtype)}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": torch.sum(torch.square(x(ins))).reshape(())}
