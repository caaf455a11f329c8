"""Static-graph model save/load.

Port of ``paddle_tpu/static/io.py``: ``save_vars`` / ``save_params`` /
``save_persistables`` and their loads. The format is the JAX package's:
``<dirname>/__params__`` holds a pickled {name: numpy array}. numpy has
no bfloat16, so a bf16 tensor is written as the float32 array of its
values (exact), and read back into its own dtype; a file written by the
JAX package (bfloat16 arrays of ``ml_dtypes``) loads too.

A load follows one rule: where the scope already holds a tensor of the
saved shape, the saved values are copied into it **in place** (cast to
its dtype, on its device); otherwise the variable is set to a new
tensor, of the program's dtype for it (else the file's), on the
executor's device. In place keeps every address a captured step was
recorded on (``framework/replay.py``): the graph's kernels, and the
TMA tensor maps that the tensor-core kernels encoded on the host
against those addresses at the capture, stay valid, and the next replay
reads the loaded values. A new tensor instead makes the executor capture
that step again (``Executor`` checks each bound persistable's address
before a replay), which encodes fresh maps.

``save_inference_model`` / ``load_inference_model`` serialize programs,
which waits for the program serializer (ROADMAP A12): both raise
``errors.Unimplemented``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import core
from ..framework import errors as _errs
from ..framework.executor import _host_tensor, _to_numpy
from ..framework.program import Parameter, Program, Variable
from ..framework.scope import Scope, global_scope

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "PARAMS_FILENAME"]

PARAMS_FILENAME = "__params__"


def _value(scope: Scope, name: str) -> Optional[np.ndarray]:
    val = scope.get(name)
    if val is None:
        return None
    if isinstance(val, torch.Tensor):
        return _to_numpy(val)
    return np.asarray(val)


def _is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None) -> List[str]:
    """Save the named ``vars`` (or the program's vars that ``predicate``
    accepts, persistables by default) to one combined pickle."""
    from ..framework.program import default_main_program

    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is not None:
        names = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    else:
        keep = predicate or _is_persistable
        names = [v.name for v in program.list_vars() if keep(v)]
    data = {}
    for n in names:
        arr = _value(scope, n)
        if arr is not None:
            data[n] = arr
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, filename or PARAMS_FILENAME), "wb") as f:
        pickle.dump(data, f, protocol=4)
    return list(data)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None) -> List[str]:
    """Trainable parameters only."""
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None) -> List[str]:
    """Parameters, optimizer state and every other persistable."""
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope)


def _new_tensor(value: np.ndarray, var: Optional[Variable],
                device: torch.device) -> torch.Tensor:
    t = _host_tensor(value)
    if var is not None:
        t = t.to(core.convert_dtype(var.dtype))
    return t.to(device)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None) -> List[str]:
    """Load a :func:`save_vars` file into ``scope`` (see the module
    docstring for the in-place rule)."""
    scope = scope or global_scope()
    with open(os.path.join(dirname, filename or PARAMS_FILENAME), "rb") as f:
        data: Dict[str, np.ndarray] = pickle.load(f)
    if vars is not None:
        names = {v.name if isinstance(v, Variable) else str(v) for v in vars}
        data = {n: v for n, v in data.items() if n in names}
    block = main_program.global_block() if main_program is not None else None
    device = (executor.device if getattr(executor, "device", None) is not None
              else core.resolve_device(core.default_place()))
    with torch.no_grad():
        for name, value in data.items():
            held = scope.get(name)
            if (isinstance(held, torch.Tensor)
                    and tuple(held.shape) == tuple(np.shape(value))):
                held.copy_(_host_tensor(value))
                continue
            var = block._find_var_recursive(name) if block else None
            scope.set(name, _new_tensor(value, var, device))
    return list(data)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None) -> List[str]:
    return load_vars(executor, dirname, main_program, filename=filename,
                     scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None) -> List[str]:
    return load_vars(executor, dirname, main_program, filename=filename,
                     scope=scope)


def _unported(what: str) -> _errs.UnimplementedError:
    return _errs.errors.Unimplemented(
        f"{what} serializes a program, which is not ported to "
        f"paddle_tpu_torch yet (ROADMAP.md queue A, item A12)")


def save_inference_model(dirname: str, feeded_var_names, target_vars,
                         executor=None, main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         scope: Optional[Scope] = None):
    raise _unported("save_inference_model")


def load_inference_model(dirname: str, executor=None, model_filename=None,
                         params_filename=None, scope: Optional[Scope] = None):
    raise _unported("load_inference_model")
