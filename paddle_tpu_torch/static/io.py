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

``save_inference_model`` / ``load_inference_model`` are the JAX
package's: ``<dirname>/__model__`` holds a pickled ``{"program":
ProgramDesc bytes, "feeds": [...], "fetches": [...]}`` of the program
pruned to the ops the targets need (``Program.serialize_to_string``), and
``__params__`` the persistables those ops read, in the format above. A
model saved by either package loads in the other.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import core
from ..framework.executor import _host_tensor, _to_numpy
from ..framework.program import Parameter, Program, Variable
from ..framework.scope import Scope, global_scope

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "MODEL_FILENAME", "PARAMS_FILENAME"]

MODEL_FILENAME = "__model__"
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


def prune_program(program: Program, feeds, targets) -> Program:
    """A copy of ``program`` keeping the ops that the ``targets`` need,
    walking back from them and stopping at the ``feeds`` (the JAX
    package's ``native._py_prune``; every var stays)."""
    feeds, needed = set(feeds), set(targets)
    ops = program.global_block().ops
    keep = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        if any(n in needed for n in ops[i].output_arg_names()):
            keep[i] = True
            needed.update(n for n in ops[i].input_arg_names()
                          if n not in feeds)
    pruned = program.clone()
    block = pruned.global_block()
    block.ops = [op for op, k in zip(block.ops, keep) if k]
    return pruned


def save_inference_model(dirname: str, feeded_var_names, target_vars,
                         executor=None, main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         scope: Optional[Scope] = None) -> List[str]:
    """Write the program pruned to what ``target_vars`` need from
    ``feeded_var_names``, and the persistables its ops read; returns the
    target names."""
    from ..framework.program import default_main_program

    program = main_program or default_main_program()
    scope = scope or global_scope()
    targets = [v.name if isinstance(v, Variable) else str(v)
               for v in target_vars]
    pruned = prune_program(program, list(feeded_var_names), targets)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "wb") as f:
        pickle.dump({"program": pruned.serialize_to_string(),
                     "feeds": list(feeded_var_names), "fetches": targets},
                    f, protocol=4)
    needed = {n for op in pruned.global_block().ops
              for n in op.input_arg_names()}
    save_vars(executor, dirname, program,
              vars=[v.name for v in program.list_vars()
                    if v.persistable and v.name in needed],
              filename=params_filename or PARAMS_FILENAME, scope=scope)
    return targets


def load_inference_model(dirname: str, executor=None, model_filename=None,
                         params_filename=None, scope: Optional[Scope] = None):
    """``(program, feed names, fetch vars)`` of a saved model; its
    persistables go into ``scope`` on the executor's device, by
    :func:`load_vars`'s rule."""
    scope = scope or global_scope()
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "rb") as f:
        payload = pickle.load(f)
    program = Program.parse_from_string(payload["program"])
    load_vars(executor, dirname, program,
              filename=params_filename or PARAMS_FILENAME, scope=scope)
    block = program.global_block()
    return program, payload["feeds"], [block.var(n)
                                       for n in payload["fetches"]]
