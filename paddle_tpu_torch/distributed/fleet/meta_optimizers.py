"""Meta-optimizers (mirrors ``paddle_tpu/distributed/fleet/meta_optimizers.py``):
``RecomputeOptimizer`` only. The others (gradient merge, pipeline,
sharding, AMP) wait for ROADMAP A10."""
from __future__ import annotations

from typing import Dict, Optional

from ...framework.backward import append_backward_with_checkpoints

__all__ = ["RecomputeOptimizer"]


class RecomputeOptimizer:
    """Activation recompute around an inner optimizer. ``backward`` builds
    the gradient with ``append_backward_with_checkpoints`` over the
    checkpoints (``configs["checkpoints"]`` or ``_set_checkpoints``): only
    the checkpoint activations stay live between the forward and the
    backward, and each segment's forward is re-emitted before its grad
    ops. With no checkpoints it is the inner optimizer's plain backward.
    ``minimize`` is that backward and the inner optimizer's
    ``apply_gradients`` (its regularization, clipping and update ops);
    any other attribute is the inner optimizer's."""

    def __init__(self, inner, configs: Optional[Dict] = None):
        self._inner = inner
        self._checkpoints = list((configs or {}).get("checkpoints", []))

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._checkpoints:
            return self._inner.backward(loss, startup_program,
                                        parameter_list, no_grad_set)
        return append_backward_with_checkpoints(
            loss, self._checkpoints,
            parameter_list=parameter_list or getattr(
                self._inner, "_parameter_list", None),
            no_grad_set=no_grad_set)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._checkpoints:
            return self._inner.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self._inner.apply_gradients(params_grads)
        return None, params_grads
