"""NN op lowerings (the GPT training subset).

Port of ``paddle_tpu/ops/nn_ops.py``: ``layer_norm`` (statistics in
fp32, ``Y`` cast back to the input dtype, ``Mean``/``Variance`` fp32),
``softmax_with_cross_entropy`` (fp32 log-softmax; hard labels; the loss
is fp32 as in the JAX package) and ``lookup_table_v2``.
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
        loss = -picked
        if ignore >= 0:
            loss = torch.where((lbl != ignore).unsqueeze(axis), loss,
                               torch.zeros_like(loss))
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
