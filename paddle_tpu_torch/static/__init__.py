"""Static-graph user API of the port (mirrors ``paddle_tpu/static``)."""
from ..framework import (
    CPUPlace,
    CUDAPlace,
    Executor,
    Program,
    Scope,
    append_backward,
    default_main_program,
    default_startup_program,
    global_scope,
    gradients,
    program_guard,
)
from . import nn
from .nn import data
