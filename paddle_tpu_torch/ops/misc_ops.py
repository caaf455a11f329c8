"""Misc op lowerings: ``top_k``.

Port of the ``top_k`` rule of ``paddle_tpu/ops/misc_ops.py`` (the fluid
``top_k`` that ``accuracy`` scripts emit; ``top_k_v2`` is in
``math_ops.py``). The module's other ops wait in ROADMAP queue A, item
A11.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import maybe, x


@register_op("top_k", no_grad_inputs=("K",))
def _top_k(ctx, ins, attrs):
    k = maybe(ins, "K")
    k = int(k) if k is not None else int(attrs.get("k", 1))
    vals, idx = torch.topk(x(ins), k, dim=-1, largest=True, sorted=True)
    return {"Out": vals, "Indices": idx.long()}
