"""``paddle.nn`` of the port: the gradient-clipping classes only
(``clip.py``). The layers, functional API and the rest of ``nn`` come
with the eager API (ROADMAP A8)."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, append_gradient_clip)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "append_gradient_clip"]
