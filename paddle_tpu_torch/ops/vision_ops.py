"""Vision op lowerings: the transposed convolution's helper.

Port of ``_conv_transpose_nd`` of ``paddle_tpu/ops/vision_ops.py``, which
``conv2d_transpose`` (``nn_ops.py``) runs; the rest of that module's ops
wait in ROADMAP queue A, item A11.
"""
from __future__ import annotations

import torch.nn.functional as F

from .nn_ops import _conv_padding


def _conv_transpose_nd(ins, attrs, nsp):
    """The transposed convolution of a Paddle filter (C_in, C_out/g,
    k...) with the JAX package's padding: the full transposed output
    (``F.conv_transpose2d``/``3d`` at padding 0) with (lo, hi) cells
    cropped a dim. ``SAME`` raises ``ValueError``, as there."""
    inp, filt = ins["Input"][0], ins["Filter"][0]
    strides = list(attrs.get("strides", [1] * nsp))
    dilations = list(attrs.get("dilations", [1] * nsp))
    groups = attrs.get("groups", 1) or 1
    ksp = filt.shape[-nsp:]
    pads = _conv_padding(attrs.get("paddings", [0] * nsp), nsp,
                         attrs.get("padding_algorithm", "EXPLICIT"),
                         ksp, strides, dilations)
    if pads == "SAME":
        raise ValueError(
            "String padding is not implemented for transposed convolution "
            "(as in the JAX package, whose lax refuses it): give the "
            "padding explicitly")
    conv = F.conv_transpose2d if nsp == 2 else F.conv_transpose3d
    out = conv(inp, filt, None, strides, 0, 0, groups, dilations)
    crop = tuple(slice(lo, out.shape[2 + i] - hi)
                 for i, (lo, hi) in enumerate(pads))
    return {"Output": out[(slice(None), slice(None)) + crop]}
