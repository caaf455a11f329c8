"""Control-flow op lowerings: ``increment`` (the subset a ported caller
appends: ``DGCMomentumOptimizer``'s step counter).

Port of the ``increment`` rule of ``paddle_tpu/ops/control_flow_ops.py``.
The rest of that module (while, conditional blocks, tensor arrays) comes
with the remaining op families (ROADMAP A11).
"""
from __future__ import annotations

from ..framework.registry import register_op
from .common import x


@register_op("increment")
def _increment(ctx, ins, attrs):
    v = x(ins)
    return {"Out": (v + attrs.get("step", 1.0)).to(v.dtype)}
