"""Math op lowerings.

Port of ``paddle_tpu/ops/math_ops.py``: the ``elementwise_*`` binaries
(add, sub, mul, div, max, min, pow, mod, floordiv), ``maximum`` and
``minimum``, the comparisons and logical binaries (bool outputs, no
gradient), ``gelu``, the activations and unaries the eager API
dispatches (``relu``, ``sigmoid``, ``tanh``, ``exp``, ``log``, ``sqrt``,
``rsqrt``, ``square``, ``abs``, ``sign``, ``silu``, ``softplus``,
``selu``, ``mish``, ``swish``, ``hard_swish``, ``hard_sigmoid``,
``leaky_relu``, ``relu6``, ``elu``), ``softmax`` and ``log_softmax``,
``scale``, ``clip``, ``matmul``/``matmul_v2``, ``bmm``, the ``reduce_*``
reductions, ``arg_max``, ``where``, ``mean``, ``sum``, ``clip_by_norm`` and
``squared_l2_norm`` (the last two and the binaries are what gradient
clipping and weight decay append), ``mul`` (static ``fc``'s product) and
``top_k_v2`` (what ``accuracy`` reads). Large products stay
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
from .common import bcast_axis, maybe, torch_dtype, x


def _binary(name, fn, stop_gradient=False):
    @register_op(name, stop_gradient=stop_gradient)
    def _lower(ctx, ins, attrs, _fn=fn):
        xv, yv = ins["X"][0], ins["Y"][0]
        yv = bcast_axis(xv, yv, attrs.get("axis", -1))
        dt = torch.promote_types(xv.dtype, yv.dtype)
        return {"Out": _fn(xv.to(dt), yv.to(dt))}

    return _lower


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_pow", torch.pow)
# jnp.mod and jnp.floor_divide round toward -inf, as torch's do
_binary("elementwise_mod", torch.remainder)
_binary("elementwise_floordiv", torch.floor_divide)
_binary("maximum", torch.maximum)
_binary("minimum", torch.minimum)
for _name, _fn in [("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)]:
    _binary(_name, _fn, stop_gradient=True)


def _unary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(x(ins))}

    return _lower


_unary("sqrt", torch.sqrt)
_unary("sign", torch.sign)
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("rsqrt", torch.rsqrt)
_unary("square", torch.square)
_unary("abs", torch.abs)
_unary("silu", F.silu)
_unary("softplus", F.softplus)
_unary("logical_not", torch.logical_not)
_unary("selu", F.selu)
_unary("mish", lambda v: v * torch.tanh(F.softplus(v)))


@register_op("swish")
def _swish(ctx, ins, attrs):
    v = x(ins)
    return {"Out": v * torch.sigmoid(attrs.get("beta", 1.0) * v)}


@register_op("hard_swish")
def _hard_swish(ctx, ins, attrs):
    v = x(ins)
    return {"Out": v * torch.clamp(v + attrs.get("offset", 3.0), 0.0,
                                   attrs.get("threshold", 6.0))
            / attrs.get("scale", 6.0)}


@register_op("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs):
    return {"Out": torch.clamp(attrs.get("slope", 0.2) * x(ins)
                               + attrs.get("offset", 0.5), 0.0, 1.0)}


@register_op("leaky_relu")
def _leaky_relu(ctx, ins, attrs):
    return {"Out": F.leaky_relu(x(ins), attrs.get("alpha", 0.02))}


@register_op("relu6")
def _relu6(ctx, ins, attrs):
    return {"Out": torch.clamp(x(ins), 0.0, attrs.get("threshold", 6.0))}


@register_op("elu")
def _elu(ctx, ins, attrs):
    return {"Out": F.elu(x(ins), attrs.get("alpha", 1.0))}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(x(ins), dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(x(ins), dim=attrs.get("axis", -1))}


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


@register_op("bmm")
def _bmm(ctx, ins, attrs):
    return {"Out": torch.matmul(ins["X"][0], ins["Y"][0])}


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


def reduce_dims(attrs, ndim):
    """The JAX package's reduced axes: every axis under ``reduce_all`` or
    an empty ``dim``, else ``dim`` (axis 0 when absent)."""
    if attrs.get("reduce_all", False):
        return tuple(range(ndim))
    dims = attrs.get("dim", attrs.get("axis", [0]))
    if isinstance(dims, int):
        dims = [dims]
    if not dims:
        return tuple(range(ndim))
    return tuple(d % ndim if ndim else 0 for d in dims)


def _prod(v, dim, keepdim):
    for d in sorted(dim, reverse=True):
        v = torch.prod(v, dim=d, keepdim=keepdim)
    return v


def _reduce(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        v = x(ins)
        dims = reduce_dims(attrs, v.dim())
        keep = attrs.get("keep_dim", False)
        if v.dim() == 0:
            return {"Out": v.clone()}
        return {"Out": _fn(v, dim=dims, keepdim=keep)}

    return _lower


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
_reduce("reduce_max", torch.amax)
_reduce("reduce_min", torch.amin)
_reduce("reduce_prod", _prod)


@register_op("arg_max", stop_gradient=True)
def _arg_max(ctx, ins, attrs):
    v = x(ins)
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        v, axis = v.reshape(-1), 0
    out = torch.argmax(v, dim=axis, keepdim=attrs.get("keepdims", False))
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "int64")))}


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


@register_op("where", no_grad_inputs=("Condition",))
def _where(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    dt = torch.promote_types(xv.dtype, yv.dtype)
    return {"Out": torch.where(ins["Condition"][0].bool(), xv.to(dt),
                               yv.to(dt))}


@register_op("mul")
def _mul(ctx, ins, attrs):
    """X flattened to 2-D at ``x_num_col_dims``, Y at ``y_num_col_dims``,
    one product; the output keeps X's leading dims (static ``fc``)."""
    xv, yv = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    lead = tuple(xv.shape[:xnc])
    rows = 1
    for d in lead:
        rows *= int(d)
    ylead = 1
    for d in yv.shape[:ync]:
        ylead *= int(d)
    out = xv.reshape(rows, -1) @ yv.reshape(ylead, -1)
    return {"Out": out.reshape(lead + (out.shape[-1],))}


@register_op("top_k_v2")
def _top_k_v2(ctx, ins, attrs):
    v = ins["X"][0]
    k = maybe(ins, "K")
    k = int(k) if k is not None else int(attrs.get("k", 1))
    axis = attrs.get("axis", -1) % v.dim()
    vals, idx = torch.topk(v, k, dim=axis,
                           largest=attrs.get("largest", True), sorted=True)
    return {"Out": vals, "Indices": idx.long()}
