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
from . import io, nn
from .io import (
    load_inference_model,
    load_params,
    load_persistables,
    load_vars,
    save_inference_model,
    save_params,
    save_persistables,
    save_vars,
)
from .nn import data

from ..jit import InputSpec  # noqa: E402,F401  (reference paddle.static.InputSpec)
