"""The ``fluid`` namespace of reference-style scripts (``import
paddle_tpu_torch.fluid as fluid``): re-exports over the port's modules.

Port of ``paddle_tpu/fluid/__init__.py``. ``fluid.layers`` is
``static.nn``; ``CompiledProgram``, ``BuildStrategy`` and
``ExecutionStrategy`` come from ``framework/compiler.py``.
``DatasetFactory``, ``InMemoryDataset`` and ``QueueDataset`` belong to the
JAX package's ``dataset.py``, which waits in ROADMAP queue A, item A12:
making one raises ``Unimplemented`` naming it.
"""
from ..framework import (
    CPUPlace,
    CUDAPlace,
    Executor,
    ParamAttr,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
)
from ..framework import errors as _errs
from ..framework import initializer, unique_name
from ..framework.backward import append_backward, gradients
from ..framework.compiler import (
    BuildStrategy,
    CompiledProgram,
    ExecutionStrategy,
)
from ..framework.program import in_dygraph_mode
from ..static import nn as layers
from ..static.nn import data

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "Program", "Scope", "ParamAttr",
    "default_main_program", "default_startup_program", "global_scope",
    "program_guard", "in_dygraph_mode", "initializer", "unique_name",
    "append_backward", "gradients", "layers", "data", "BuildStrategy",
    "CompiledProgram", "ExecutionStrategy", "DatasetFactory",
    "InMemoryDataset", "QueueDataset",
]


class _Unported:
    def __init__(self, *args, **kwargs):
        raise _errs.errors.Unimplemented(
            f"fluid.{type(self).__name__} is not ported: the JAX package's "
            f"dataset.py comes with the parameter-server slice (ROADMAP.md "
            f"queue A, item A12)")


class DatasetFactory(_Unported):
    pass


class InMemoryDataset(_Unported):
    pass


class QueueDataset(_Unported):
    pass
