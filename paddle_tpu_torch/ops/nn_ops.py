"""NN op lowerings.

Port of ``paddle_tpu/ops/nn_ops.py``: ``layer_norm`` (statistics in
fp32, ``Y`` cast back to the input dtype, ``Mean``/``Variance`` fp32),
``softmax_with_cross_entropy`` (fp32 log-softmax; hard labels; the loss
is fp32 as in the JAX package), ``lookup_table_v2``, ``dropout`` and the
eager API's losses: ``mse_loss``, ``l1_loss``, ``bce_loss``,
``sigmoid_cross_entropy_with_logits``, ``kldiv_loss``, ``huber_loss``
and ``nll_loss``.

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
