"""Shared helpers for op lowering rules (port of ``paddle_tpu/ops/common.py``)."""
from __future__ import annotations

import torch

from ..framework import core


def x(ins, slot="X"):
    return ins[slot][0]


def maybe(ins, slot, default=None):
    vs = ins.get(slot)
    return vs[0] if vs else default


def torch_dtype(attr_val, default="float32") -> torch.dtype:
    """An attr's dtype name (or a dtype) as a torch dtype."""
    if attr_val is None or attr_val == "":
        attr_val = default
    return core.convert_dtype(attr_val)


def bcast_axis(xv, yv, axis: int):
    """Elementwise broadcast of the JAX package: align Y's dims to X
    starting at ``axis`` (-1 = numpy trailing alignment)."""
    if xv.dim() == yv.dim() or yv.dim() == 0:
        return yv
    if axis is None or axis == -1:
        axis = xv.dim() - yv.dim()
    shape = [1] * axis + list(yv.shape) + [1] * (xv.dim() - axis - yv.dim())
    return yv.reshape(shape)
