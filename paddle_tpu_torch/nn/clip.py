"""Gradient clipping: ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, the fluid aliases and ``append_gradient_clip``.

Port of ``paddle_tpu/nn/clip.py``, op for op: each class appends ops to
the program (``clip``; ``clip_by_norm``; ``squared_l2_norm`` a gradient,
``sum``, ``sqrt``, ``elementwise_max`` against the clip norm,
``elementwise_div`` and ``elementwise_mul``), skipping parameters whose
``need_clip`` is False. The ops keep the JAX package's dtypes
(``ops/math_ops.py``): on a bf16 program the global norm is summed and
rooted in bf16, the scale is fp32 (bf16 against the fp32 clip norm), and
the clipped gradients are fp32, as ``jnp`` promotes them.
"""
from __future__ import annotations

from ..framework import LayerHelper

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clipped to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        helper = LayerHelper("clip_by_value")
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            c = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("clip", inputs={"X": g}, outputs={"Out": c},
                             attrs={"min": self.min, "max": self.max})
            out.append((p, c))
        return out


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        helper = LayerHelper("clip_by_norm")
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            c = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("clip_by_norm", inputs={"X": g},
                             outputs={"Out": c},
                             attrs={"max_norm": self.clip_norm})
            out.append((p, c))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient times ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for p, g in params_grads:
            if not _clipped(p, g):
                continue
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": g},
                             outputs={"Out": sq})
            sq_norms.append(sq)
        if not sq_norms:
            return params_grads
        total = helper.create_variable_for_type_inference(sq_norms[0].dtype)
        helper.append_op("sum", inputs={"X": sq_norms},
                         outputs={"Out": total})
        gnorm = helper.create_variable_for_type_inference(total.dtype)
        helper.append_op("sqrt", inputs={"X": total}, outputs={"Out": gnorm})
        clip_c = helper.create_variable_for_type_inference(total.dtype)
        helper.append_op("fill_constant", outputs={"Out": clip_c},
                         attrs={"shape": [], "value": self.clip_norm,
                                "dtype": "float32"})
        denom = helper.create_variable_for_type_inference(total.dtype)
        helper.append_op("elementwise_max", inputs={"X": gnorm, "Y": clip_c},
                         outputs={"Out": denom})
        scale = helper.create_variable_for_type_inference(total.dtype)
        helper.append_op("elementwise_div", inputs={"X": clip_c, "Y": denom},
                         outputs={"Out": scale})
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            c = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("elementwise_mul", inputs={"X": g, "Y": scale},
                             outputs={"Out": c})
            out.append((p, c))
        return out


# fluid-era aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def append_gradient_clip(params_grads, clip):
    return clip(params_grads) if clip is not None else params_grads
