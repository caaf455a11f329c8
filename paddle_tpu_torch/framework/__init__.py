"""Framework of the port: program IR, registry, autodiff, executor, scope.

Mirrors ``paddle_tpu/framework``; the static-graph entry points are the
JAX package's (``Program``, ``program_guard``, ``Executor``, ``Scope``).
"""
from . import core, registry, unique_name
from .backward import append_backward, calc_gradient, gradients
from .core import (CPUPlace, CUDAPlace, Place, convert_dtype, default_place,
                   get_device, set_device)
from .executor import Executor, lower_block, lower_op
from .initializer import (
    ConstantInitializer,
    MSRAInitializer,
    NormalInitializer,
    NumpyArrayInitializer,
    TruncatedNormalInitializer,
    UniformInitializer,
    XavierInitializer,
)
from .layer_helper import LayerHelper
from .param_attr import ParamAttr
from .program import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    device_guard,
    program_guard,
)
from .registry import LoweringContext, register_op
from .scope import Scope, global_scope
