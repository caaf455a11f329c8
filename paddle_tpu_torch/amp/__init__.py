"""Automatic mixed precision for the eager API.

Port of ``paddle_tpu/amp/__init__.py``: ``auto_cast`` switches a cast
policy that the dygraph tracer applies to each op's inputs
(``amp_cast_inputs``): the white list's ops (matmuls, convolutions,
``fused_attention_tpu``) take their floating inputs in the compute dtype
(bfloat16 by default), the black list's (softmax, the losses, the norms,
the reductions) in float32; every other op takes its inputs as they come.
Parameters stay float32: the cast is made inside the op's autograd
record (``LoweringContext.record``), so a parameter's gradient comes back
through the cast in float32. ``GradScaler`` passes through under bfloat16
(its exponent range is float32's) and scales the loss dynamically under
float16, as in the reference. ``decorate(level="O2")`` casts a model's
floating parameters to the compute dtype.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "autocast",
           "amp_cast_inputs", "amp_state", "GradScaler", "decorate"]

# ops whose inputs are cast to the compute dtype (reference white list)
WHITE_LIST = {
    "conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
    "matmul", "matmul_v2", "mul", "bmm", "fused_attention_tpu",
}
# ops that run in fp32 (reference black list)
BLACK_LIST = {
    "softmax", "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "reduce_sum", "reduce_mean", "mean", "sum", "exp", "log",
    "squared_l2_norm", "p_norm", "frobenius_norm",
}

_amp_state = {"enabled": False, "dtype": "bfloat16", "level": "O1"}


def amp_state():
    return _amp_state


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """``paddle.amp.auto_cast``: the tracer's cast policy inside the
    block."""
    old = dict(_amp_state)
    _amp_state.update({"enabled": enable, "dtype": dtype, "level": level})
    if custom_white_list:
        _amp_state["extra_white"] = set(custom_white_list)
    if custom_black_list:
        _amp_state["extra_black"] = set(custom_black_list)
    try:
        yield
    finally:
        _amp_state.clear()
        _amp_state.update(old)


autocast = auto_cast


def _compute_dtype() -> torch.dtype:
    return (torch.bfloat16 if _amp_state["dtype"] in ("bfloat16", "bf16")
            else torch.float16)


def _cast_all(ins, want, only=None):
    return {k: [v.to(want) if isinstance(v, torch.Tensor)
                and v.is_floating_point() and (only is None or v.dtype in only)
                else v for v in vs] for k, vs in ins.items()}


def amp_cast_inputs(op_type: str, ins: dict):
    """The inputs of ``op_type`` under the current policy (the tracer
    applies it inside the op's autograd record)."""
    if not _amp_state["enabled"]:
        return ins
    if op_type in WHITE_LIST or op_type in _amp_state.get("extra_white", ()):
        return _cast_all(ins, _compute_dtype())
    if op_type in BLACK_LIST or op_type in _amp_state.get("extra_black", ()):
        return _cast_all(ins, torch.float32, (torch.bfloat16, torch.float16))
    return ins


class GradScaler:
    """Reference dygraph GradScaler (dygraph/amp/loss_scaler.py). Under
    bfloat16 no scaling is needed; under float16 it runs the reference's
    dynamic loss scaling."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable and _amp_state.get("dtype") == "float16"
        self._scale = init_loss_scaling if self._enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable or self._scale == 1.0:
            return loss
        from ..ops.api import scale as _scale

        return _scale(loss, self._scale)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        params = [p for p in (optimizer._parameter_list or [])
                  if p.grad is not None]
        # one host read for every gradient's finiteness
        finite = torch.stack([torch.isfinite(p.grad._value).all()
                              for p in params]).all() if params else True
        self._found_inf = not bool(finite)
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._dynamic and self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
            optimizer.clear_grad()
            return
        inv = 1.0 / self._scale
        for p in params:
            p.grad._value = p.grad._value * inv
        optimizer.step()
        self._good += 1
        self._bad = 0
        if self._dynamic and self._good >= self._incr_every:
            self._scale *= self._incr_ratio
            self._good = 0

    def update(self):
        pass

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None):
    """``paddle.amp.decorate``: O2 casts the models' floating parameters to
    the compute dtype."""
    if level == "O2" and models is not None:
        dt = (torch.bfloat16 if dtype in ("bfloat16", "bf16")
              else torch.float16)
        for m in (models if isinstance(models, (list, tuple)) else [models]):
            for p in m.parameters():
                if p._value.is_floating_point():
                    p._value = p._value.to(dt)
    if optimizers is None:
        return models
    return models, optimizers
