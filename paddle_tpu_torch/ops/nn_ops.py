"""NN op lowerings: conv, pool, norms, dropout, losses, embeddings.

Port of ``paddle_tpu/ops/nn_ops.py``, every op of it: ``conv2d``,
``depthwise_conv2d``, ``conv2d_transpose`` and ``conv3d``; ``pool2d`` and
``max_pool2d_with_index``; ``batch_norm``, ``layer_norm``,
``instance_norm``, ``group_norm`` and ``norm``; ``dropout``; the losses
(``softmax_with_cross_entropy``, ``cross_entropy``/``cross_entropy2``,
``mse_loss``, ``l1_loss``, ``bce_loss``,
``sigmoid_cross_entropy_with_logits``, ``kldiv_loss``,
``smooth_l1_loss``, ``huber_loss``, ``nll_loss``, ``hinge_loss``,
``square_error_cost``); the lookups (``lookup_table``,
``lookup_table_v2``, ``embedding``) and ``label_smooth``,
``pixel_shuffle`` and ``grid_sampler``.

None of these is a TPU kernel in the JAX package: it convolves through
``lax.conv_general_dilated``, pools through ``lax.reduce_window`` and
normalizes in plain ``jnp``. So the port convolves through
``torch.nn.functional`` (cuDNN on the card), pools through
``F.max_pool2d``/``F.avg_pool2d`` on explicitly padded inputs (the JAX
window rules: ``-inf`` padding for max, exclusive counts of the unpadded
cells for an exclusive average), and writes ``batch_norm`` as plain
tensor ops copying the JAX formula: the batch variance is
E[x^2] - E[x]^2 in fp32, the running statistics move as
``running * momentum + batch * (1 - momentum)`` (``F.batch_norm`` would
keep the unbiased variance, with its momentum the other way round), and
``SavedVariance`` is ``rsqrt(var + eps)``.

Shared with the JAX package, kept: adaptive pooling to sizes that do not
divide the input raises ``NotImplementedError``, and
``max_pool2d_with_index``'s ``Mask`` is all zeros.

One difference is kept on purpose: a hard label equal to
``ignore_index`` gives a loss and a gradient of 0 whatever the index's
sign. The JAX rule masks only when ``ignore_index >= 0``, so under its
default of -100 a label of -100 picks the logit at ``V - 100`` (or NaN
where ``V < 100``), and ``F.cross_entropy(..., ignore_index=-100)``
trains on the positions it was asked to ignore.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .common import maybe, x


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    v = x(ins)
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    red = tuple(range(begin, v.dim()))
    vf = v.float()
    mean = vf.mean(dim=red, keepdim=True)
    var = (vf - mean).square().mean(dim=red, keepdim=True)
    y = (vf - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(v.shape[begin:])
    scale, bias = maybe(ins, "Scale"), maybe(ins, "Bias")
    if scale is not None:
        y = y * scale.reshape(norm_shape).float()
    if bias is not None:
        y = y + bias.reshape(norm_shape).float()
    lead = tuple(v.shape[:begin])
    return {"Y": y.to(v.dtype), "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_op("softmax_with_cross_entropy", no_grad_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.dim()
    lf = logits.float()
    logp = lf - torch.logsumexp(lf, dim=axis, keepdim=True)
    softmax = logp.exp().to(logits.dtype)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        ignore = attrs.get("ignore_index", -100)
        lbl = lbl.long()
        picked = torch.gather(logp, axis, lbl.clamp(0, logits.shape[axis] - 1)
                              .unsqueeze(axis))
        # a label equal to ignore_index, whatever its sign, adds nothing to
        # the loss or the gradient (the JAX rule masks only ignore >= 0)
        loss = torch.where((lbl != ignore).unsqueeze(axis), -picked,
                           torch.zeros_like(picked))
    return {"Softmax": softmax, "Loss": loss}


@register_op("lookup_table_v2", no_grad_inputs=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    out = F.embedding(ids.long(), w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx).unsqueeze(-1), out,
                          torch.zeros_like(out))
    return {"Out": out}


@register_op("dropout", uses_rng=True)
def _dropout(ctx, ins, attrs):
    """Keeps an element where the lowering context's counter-based draw
    (``LoweringContext.uniform``) is below ``1 - p``; ``Mask`` is the keep
    mask as uint8."""
    v = x(ins)
    p = float(attrs.get("dropout_prob", 0.5))
    upscale = (attrs.get("dropout_implementation", "upscale_in_train")
               == "upscale_in_train")
    if attrs.get("is_test", False) or p == 0.0:
        out = v if upscale else v * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(v, dtype=torch.uint8)}
    keep = ctx.uniform(attrs.get("_rng_id", 0), v.shape) < (1.0 - p)
    kept = v / (1.0 - p) if upscale else v
    out = torch.where(keep, kept, torch.zeros_like(kept)).to(v.dtype)
    return {"Out": out, "Mask": keep.to(torch.uint8)}


@register_op("mse_loss", no_grad_inputs=("Label",))
def _mse_loss(ctx, ins, attrs):
    return {"Out": torch.square(ins["X"][0] - ins["Label"][0])}


@register_op("l1_loss")
def _l1_loss(ctx, ins, attrs):
    return {"Out": torch.abs(ins["X"][0] - ins["Y"][0])}


@register_op("bce_loss")
def _bce_loss(ctx, ins, attrs):
    xv, label = ins["X"][0], ins["Label"][0]
    xv = torch.clamp(xv, 1e-12, 1.0 - 1e-7)
    return {"Out": -(label * torch.log(xv) + (1 - label) * torch.log(1 - xv))}


@register_op("sigmoid_cross_entropy_with_logits", no_grad_inputs=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    xv, label = ins["X"][0], ins["Label"][0]
    loss = (torch.clamp(xv, min=0) - xv * label
            + torch.log1p(torch.exp(-torch.abs(xv))))
    ignore = attrs.get("ignore_index", -1)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        loss = loss / torch.clamp((label != ignore).sum(), min=1)
    return {"Out": loss}


@register_op("kldiv_loss", no_grad_inputs=("Target",))
def _kldiv_loss(ctx, ins, attrs):
    xv, target = ins["X"][0], ins["Target"][0]
    loss = torch.where(target > 0, target * (torch.log(target) - xv),
                       torch.zeros_like(xv))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / xv.shape[0]
    return {"Loss": loss}


@register_op("huber_loss", no_grad_inputs=("Y",))
def _huber_loss(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = yv - xv
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * torch.square(r),
                       delta * (ar - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("nll_loss", no_grad_inputs=("Label",))
def _nll_loss(ctx, ins, attrs):
    xv, label = ins["X"][0], ins["Label"][0]
    loss = -torch.gather(xv, 1, label.long()[:, None])[:, 0]
    total = torch.tensor(float(xv.shape[0]), dtype=xv.dtype,
                         device=xv.device)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    return {"Out": loss, "Total_weight": total}


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _conv_padding(paddings, ndims, padding_algorithm, ksize, strides,
                  dilations, in_sizes=None):
    """The JAX package's padding forms as (lo, hi) pairs a spatial dim:
    ``SAME`` (XLA's: output ceil(in / stride), the odd cell at the end;
    needs ``in_sizes``), ``VALID``, one value a dim or two."""
    if padding_algorithm == "SAME":
        if in_sizes is None:
            return "SAME"
        pads = []
        for n, k, s, d in zip(in_sizes, ksize, strides, dilations):
            out = -(-int(n) // int(s))
            total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if padding_algorithm == "VALID":
        return [(0, 0)] * ndims
    p = list(paddings)
    if len(p) == ndims:
        return [(int(v), int(v)) for v in p]
    if len(p) == 2 * ndims:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(ndims)]
    return [(0, 0)] * ndims


def _pad_spatial(v, pads, value=0.0):
    """``F.pad`` of the trailing spatial dims by (lo, hi) pairs in dim
    order; a symmetric padding is returned as ints for the op itself."""
    if all(lo == hi for lo, hi in pads):
        return v, [lo for lo, _ in pads]
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(v, flat, value=value), [0] * len(pads)


def _conv_nd(inp, filt, attrs, nsp):
    strides = list(attrs.get("strides", [1] * nsp))
    dilations = list(attrs.get("dilations", [1] * nsp))
    groups = attrs.get("groups", 1) or 1
    pads = _conv_padding(attrs.get("paddings", [0] * nsp), nsp,
                         attrs.get("padding_algorithm", "EXPLICIT"),
                         filt.shape[-nsp:], strides, dilations,
                         inp.shape[-nsp:])
    inp, pad = _pad_spatial(inp, pads)
    conv = F.conv2d if nsp == 2 else F.conv3d
    return conv(inp, filt, None, strides, pad, dilations, groups)


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW with an OIHW filter, or NHWC with the JAX package's HWIO
    filter; a bf16 convolution accumulates in fp32 (cuDNN's) and returns
    the input's dtype."""
    inp, filt = ins["Input"][0], ins["Filter"][0]
    nhwc = attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout")
    if nhwc:
        inp, filt = inp.permute(0, 3, 1, 2), filt.permute(3, 2, 0, 1)
    out = _conv_nd(inp, filt, attrs, 2).to(inp.dtype)
    return {"Output": out.permute(0, 2, 3, 1) if nhwc else out}


register_op("depthwise_conv2d")(_conv2d)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    from .vision_ops import _conv_transpose_nd

    return _conv_transpose_nd(ins, attrs, 2)


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    return {"Output": _conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 3)}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def _reduce_hw(v, ptype, dims):
    if ptype == "max":
        return torch.amax(v, dim=dims)
    return torch.mean(v, dim=dims)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    v = x(ins)  # NCHW
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    paddings = [int(p) for p in attrs.get("paddings", [0, 0])]
    adaptive = attrs.get("adaptive", False)
    if attrs.get("global_pooling", False) or (adaptive and ksize == [1, 1]):
        return {"Out": _reduce_hw(v, ptype, (2, 3)).reshape(
            v.shape[0], v.shape[1], 1, 1)}
    if adaptive:
        oh, ow = ksize
        h, w = v.shape[2], v.shape[3]
        if h % oh == 0 and w % ow == 0:
            r = v.reshape(v.shape[0], v.shape[1], oh, h // oh, ow, w // ow)
            return {"Out": _reduce_hw(r, ptype, (3, 5))}
        raise NotImplementedError("adaptive pool with non-divisible sizes")
    if len(paddings) == 2:
        pads = [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    else:
        pads = [(paddings[0], paddings[1]), (paddings[2], paddings[3])]
    # torch pads at most half a window itself; beyond that, pad first
    inside = all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ksize))
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    if ptype == "max":
        if inside:
            return {"Out": F.max_pool2d(v, ksize, strides,
                                        [lo for lo, _ in pads])}
        low = (float("-inf") if v.dtype.is_floating_point
               else torch.iinfo(v.dtype).min)
        return {"Out": F.max_pool2d(F.pad(v, flat, value=low), ksize,
                                    strides)}
    exclusive = attrs.get("exclusive", True)
    if inside:
        return {"Out": F.avg_pool2d(v, ksize, strides, [lo for lo, _ in pads],
                                    count_include_pad=not exclusive)}
    summed = F.avg_pool2d(F.pad(v, flat), ksize, strides, divisor_override=1)
    if exclusive and any(p != (0, 0) for p in pads):
        ones = F.pad(torch.ones_like(v[:1, :1]), flat)
        counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        return {"Out": summed / counts}
    return {"Out": summed / float(ksize[0] * ksize[1])}


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    """The JAX package's ``Mask`` is all zeros; so is the port's."""
    out = _pool2d(ctx, ins, {**attrs, "pooling_type": "max"})["Out"]
    return {"Out": out, "Mask": torch.zeros(out.shape, dtype=torch.int32,
                                            device=out.device)}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@register_op("batch_norm", no_grad_inputs=("Mean", "Variance"))
def _batch_norm(ctx, ins, attrs):
    v = x(ins)
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else v.dim() - 1
    red = tuple(i for i in range(v.dim()) if i != axis)
    bshape = [1] * v.dim()
    bshape[axis] = v.shape[axis]
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        saved_mean, saved_var = mean, var
        mean_out, var_out = mean, var
    else:
        vf = v.float()  # statistics in fp32 whatever the activations' dtype
        bmean = vf.mean(dim=red)
        bvar = vf.square().mean(dim=red) - bmean.square()
        use_mean, use_var = bmean, bvar
        saved_mean, saved_var = bmean, torch.rsqrt(bvar + eps)
        mean_out = mean * momentum + bmean.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + bvar.to(var.dtype) * (1 - momentum)
    inv = torch.rsqrt(use_var.float() + eps)
    y = ((v.float() - use_mean.reshape(bshape))
         * (inv * scale.float()).reshape(bshape)
         + bias.float().reshape(bshape))
    return {"Y": y.to(v.dtype), "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}


@register_op("instance_norm")
def _instance_norm(ctx, ins, attrs):
    v = x(ins)  # NCHW...
    eps = attrs.get("epsilon", 1e-5)
    red = tuple(range(2, v.dim()))
    mean = v.mean(dim=red, keepdim=True)
    var = v.var(dim=red, unbiased=False, keepdim=True)
    y = (v - mean) * torch.rsqrt(var + eps)
    bshape = (1, v.shape[1]) + (1,) * (v.dim() - 2)
    scale, bias = maybe(ins, "Scale"), maybe(ins, "Bias")
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    nc = (v.shape[0], v.shape[1])
    return {"Y": y, "SavedMean": mean.reshape(nc),
            "SavedVariance": torch.rsqrt(var + eps).reshape(nc)}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    v = x(ins)  # NCHW
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = v.shape[0], v.shape[1]
    g = v.reshape((n, groups, c // groups) + tuple(v.shape[2:]))
    red = tuple(range(2, g.dim()))
    mean = g.mean(dim=red, keepdim=True)
    var = g.var(dim=red, unbiased=False, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(v.shape)
    bshape = (1, c) + (1,) * (v.dim() - 2)
    scale, bias = maybe(ins, "Scale"), maybe(ins, "Bias")
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": y, "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


@register_op("norm")
def _norm(ctx, ins, attrs):
    v = x(ins)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(v.square().sum(dim=attrs.get("axis", -1), keepdim=True)
                      + eps)
    return {"Out": v / norm, "Norm": norm}


# ---------------------------------------------------------------------------
# the remaining losses
# ---------------------------------------------------------------------------


def _picked(xv, label):
    """``take_along_axis`` of the last axis at a hard label (its trailing
    1 squeezed), keeping that axis."""
    lbl = label
    if lbl.dim() == xv.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    return torch.gather(xv, -1, lbl.long().unsqueeze(-1))


@register_op("cross_entropy", no_grad_inputs=("Label",))
def _cross_entropy(ctx, ins, attrs):
    xv, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(torch.clamp(xv, min=1e-12))).sum(
            dim=-1, keepdim=True)
    else:
        loss = -torch.log(torch.clamp(_picked(xv, label), min=1e-12))
    return {"Y": loss}


@register_op("cross_entropy2", no_grad_inputs=("Label",))
def _cross_entropy2(ctx, ins, attrs):
    y = _cross_entropy(ctx, ins, attrs)["Y"]
    return {"Y": y, "XShape": torch.zeros(1, dtype=torch.float32,
                                          device=y.device), "MatchX": y}


@register_op("smooth_l1_loss", no_grad_inputs=("Y",))
def _smooth_l1(ctx, ins, attrs):
    xv, yv = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = xv - yv
    inside, outside = maybe(ins, "InsideWeight"), maybe(ins, "OutsideWeight")
    if inside is not None:
        diff = diff * inside
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff.square(), ad - 0.5 / s2)
    if outside is not None:
        loss = loss * outside
    return {"Out": loss.reshape(xv.shape[0], -1).sum(dim=1, keepdim=True),
            "Diff": diff}


@register_op("hinge_loss", no_grad_inputs=("Labels",))
def _hinge_loss(ctx, ins, attrs):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": torch.clamp(1.0 - (2.0 * labels - 1.0) * logits, min=0.0)}


@register_op("square_error_cost", no_grad_inputs=("Y",))
def _square_error_cost(ctx, ins, attrs):
    return {"Out": torch.square(ins["X"][0] - ins["Y"][0])}


# ---------------------------------------------------------------------------
# the remaining lookups and misc
# ---------------------------------------------------------------------------


@register_op("lookup_table", no_grad_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return _lookup_table_v2(ctx, {"W": [w], "Ids": [ids]}, attrs)


@register_op("embedding", no_grad_inputs=("Ids",))
def _embedding(ctx, ins, attrs):
    return _lookup_table_v2(ctx, ins, attrs)


@register_op("label_smooth", no_grad_inputs=("PriorDist",))
def _label_smooth(ctx, ins, attrs):
    label = x(ins)
    eps = attrs.get("epsilon", 0.0)
    prior = maybe(ins, "PriorDist")
    if prior is not None:
        return {"Out": (1 - eps) * label + eps * prior}
    return {"Out": (1 - eps) * label + eps / label.shape[-1]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    v = x(ins)
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = v.shape
    out = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": out.reshape(n, c // (r * r), h * r, w * r)}


@register_op("grid_sampler", no_grad_inputs=("Grid",))
def _grid_sampler(ctx, ins, attrs):
    """Bilinear sampling at align-corners grid coordinates, indices
    clamped to the border (the JAX rule)."""
    v, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = v.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    bidx = torch.arange(n, device=v.device)[:, None, None]

    def gather(yy, xx):
        return v[bidx, :, yy, xx]  # (N, Hg, Wg, C)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return {"Output": torch.movedim(top * (1 - wy) + bot * wy, -1, 1)}
