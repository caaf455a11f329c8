"""Dygraph mode management: enable/disable, guard, no_grad, to_tensor.

Port of ``paddle_tpu/dygraph/base.py``. As in paddle 2.0 and the
reference, dygraph is the default mode: ``import paddle_tpu_torch``
enables it (which only sets the active tracer: nothing touches the device
until the first op), and ``paddle_tpu_torch.enable_static()`` switches to
graph building. Eager parameters are initialised by the port's own
initializers: the initializer's startup op runs once, eagerly, on the
default place (:func:`eval_initializer`), drawing from the counter-based
hash of the tracer's seed and the parameter's index. An optimizer's
dygraph ``step`` emits its update ops through the tracer
(:func:`_apply_dygraph_update`), so ``adam`` runs the fused Adam kernel.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from ..framework import core
from ..framework import initializer as init_mod
from ..framework import program as framework
from ..framework.registry import LoweringContext
from .tracer import Tracer
from .varbase import Tensor, to_torch

_default_tracer: Optional[Tracer] = None


def _active_tracer() -> Optional[Tracer]:
    return framework._current_tracer()


def enabled() -> bool:
    return framework.in_dygraph_mode()


def enable_dygraph(place=None):
    global _default_tracer
    if _default_tracer is None:
        _default_tracer = Tracer()
    framework._switch_tracer(_default_tracer)


def disable_dygraph():
    framework._switch_tracer(None)


@contextlib.contextmanager
def guard(place=None):
    prev = framework._current_tracer()
    enable_dygraph(place)
    try:
        yield
    finally:
        framework._switch_tracer(prev)


class no_grad:
    """``paddle.no_grad``: ops inside record nothing. A context manager or
    a decorator."""

    def __enter__(self):
        self._tracer = _active_tracer()
        if self._tracer is not None:
            self._old = self._tracer.enable_grad
            self._tracer.enable_grad = False
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            self._tracer.enable_grad = self._old
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with no_grad():
                return fn(*a, **kw)

        return wrapped


def to_variable(value, name=None, zero_copy=None, dtype=None):
    if isinstance(value, Tensor):
        return value
    return Tensor(value, name=name, stop_gradient=True, dtype=dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a Tensor on ``place`` (the default place, the
    card, unless the caller names the CPU)."""
    if isinstance(data, Tensor):
        t = data
        if dtype is not None and core.convert_dtype(dtype) != data.dtype:
            t = data.astype(dtype)
        t.stop_gradient = stop_gradient
        return t
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


# -- initializer evaluation for eager parameter creation --------------------


def eval_initializer(initializer, shape, dtype, seed_step,
                     device=None) -> torch.Tensor:
    """Run ``initializer``'s startup op once, eagerly: a parameter's value
    on ``device`` (the default place's when None). Random initializers
    draw from the counter-based hash of ``seed_step`` (seed, index) unless
    they fix their own seed."""
    from ..framework.executor import lower_op

    if initializer is None:
        initializer = init_mod.XavierInitializer()
    device = device or core.resolve_device(core.default_place())
    prog = framework.Program()
    block = prog.global_block()
    var = block.create_var(name="param", shape=[int(d) for d in shape],
                           dtype=dtype, persistable=True)
    initializer(var, block)
    ctx = LoweringContext(device, seed_step=seed_step)
    env = {}
    with torch.no_grad():
        for i, op in enumerate(block.ops):
            lower_op(ctx, op, env, op_idx=i)
    return env["param"]


def _apply_dygraph_update(optimizer, params_grads):
    """Run the optimizer's update ops eagerly (the dygraph twin of
    ``apply_gradients``): the decay and clip ops, then one update op per
    parameter, each through the tracer."""
    tracer = _active_tracer()
    with no_grad():
        params_grads = optimizer._apply_decay_and_clip(params_grads)
        lr = Tensor(to_torch(np.float32(optimizer.get_lr()),
                             place=params_grads[0][0].place),
                    stop_gradient=True)

        class _DyBlock:
            """A duck-typed Block: update ops go to the tracer."""

            @staticmethod
            def append_op(type, inputs=None, outputs=None, attrs=None):
                return tracer.trace_op(type, inputs or {}, outputs or {},
                                       attrs or {})

        block = _DyBlock()
        for p, g in params_grads:
            optimizer._append_optimize_op(block, (p, g), lr)
