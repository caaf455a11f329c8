"""Dygraph (define-by-run) mode of the port: the tracer, the eager
Tensor and the mode switches (port of ``paddle_tpu/dygraph``)."""
from .base import (
    disable_dygraph,
    enable_dygraph,
    enabled,
    guard,
    no_grad,
    to_tensor,
    to_variable,
)
from .tracer import Tracer
from .varbase import Parameter, Tensor
