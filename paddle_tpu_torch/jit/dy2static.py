"""dygraph->static AST transpiler: tensor-dependent Python control flow.

Port of ``paddle_tpu/jit/dy2static.py``. The source transform is the JAX
package's, copied (``_ControlFlowTransformer``, ``ast_transform``): a
tensor-dependent ``if`` becomes branch functions and
:func:`convert_ifelse`, a ``while`` or ``for i in range(...)`` becomes
cond/body functions over the loop-carried names and
:func:`convert_while_loop`, and ``break``/``continue``/``return`` inside
a loop become flag carries (``cf_live``, ``select_return``). The
converters are the port's own.

The JAX package lowers a tensor condition met under its ``jax.jit``
trace to ``lax.cond`` / ``lax.while_loop`` inside the compiled unit. The
port compiles a function as a CUDA graph (``jit.StaticFunction``), and a
graph replays fixed work: it can neither read a value on the host nor
branch on the device (PyTorch 2.11, which the card runs, has no API for
CUDA's conditional nodes). So a condition is *traced* here when it is a
Tensor met inside a compiled unit (:class:`Unit`), and:

- **A tensor ``if`` in the function** reads its predicate on the host
  (one device-to-host read) and runs the taken branch; the unit then
  takes the **loop route**: the function runs op by op, never as one
  graph.
- **A tensor loop** (``while``, ``for i in range(tensor)``) takes the
  loop route too: each trip's decision is read on the host, one read a
  trip, and the loop body, with the next trip's condition, is a
  ``replay.Captured`` graph of its own (:class:`_LoopBody`), keyed by
  the carried values' shapes and dtypes and by what the body reads from
  the enclosing function (its closure, copied into the body's buffers
  each time the loop is entered). Its first trip runs eagerly,
  its second is captured, every later one is a replay; the body writes
  the carried values back into its own buffers, inside the graph. A
  trip whose carries are not all tensors (a loop-local name the first
  time the loop runs; later runs start it as zeros of what that trip
  assigned, as the JAX package does), or whose body changes a carry's
  shape or dtype, runs op by op.
- **A tensor ``if`` inside a captured loop body** runs both branches
  and picks each output on the device (``torch.where``): the body stays
  one graph and its result is the taken branch's, bit for bit.
- A condition that is a Python value runs as Python: a Python loop
  unrolls into the graph, as the JAX trace unrolls it.

Inside a compiled unit a Tensor's value cannot be read on the host:
``bool()``, ``float()``, ``int()``, ``.item()`` and ``.numpy()`` raise
:class:`Dy2StaticError` (the JAX package's tracer raises its
concretization error there), and :func:`assert_plain` guards the
constructs the transform leaves in Python form. Outside a compiled unit
(an eager call, ``PADDLE_TPU_EAGER=1``) every converter runs plain
Python on concrete values.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import functools
import inspect
import textwrap
from typing import Any, Callable, Dict, List, Optional

import torch

from ..dygraph import varbase as _varbase
from ..dygraph.varbase import Tensor
from ..framework import core
from ..framework import program as _framework
from ..framework import replay as _replay

__all__ = [
    "ast_transform", "convert_ifelse", "convert_while_loop", "assert_plain",
    "Dy2StaticError", "Unit",
]


class Dy2StaticError(NotImplementedError):
    pass


# ---------------------------------------------------------------------------
# compiled units (the port's counterpart of the jax.jit trace)
# ---------------------------------------------------------------------------

_HOST_READ = (
    "to_static: the value of a tensor is not concrete while a compiled "
    "function runs (bool(), float(), int(), .item() and .numpy() would "
    "read it on the host, and a CUDA graph replays no host work); write "
    "the condition as a tensor `if`/`while` for the transform, or read "
    "the value outside the function")
_MAX_LOOP_BODIES = 8


def host_read_refused() -> Dy2StaticError:
    return Dy2StaticError(_HOST_READ)


class Constants:
    """The device copies of host values (``paddle.to_tensor(0.0)``, the
    scalar of ``x * 2.0``) that a unit's Python makes. A host-to-device
    copy cannot be captured: the warm-up run records each copy here by
    its bytes, and a capture takes the recorded tensor. A value the
    warm-up did not make changes from call to call, so a capture that
    meets one raises: a replay would keep the value it was captured
    with."""

    def __init__(self):
        self.values: Dict[tuple, torch.Tensor] = {}
        self.capturing = False

    def __call__(self, arr, dtype: Optional[torch.dtype],
                 device: torch.device,
                 make: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The device tensor of host array ``arr`` as ``dtype`` (None: its
        own) on ``device``; ``make()`` copies it there."""
        key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, device)
        t = self.values.get(key)
        if t is not None:
            return t
        if not self.capturing:
            t = self.values[key] = make()
            return t
        raise Dy2StaticError(
            f"to_static: a host value of shape {arr.shape} became a tensor "
            f"while the function was captured, but not in its warm-up run; "
            f"a capture cannot copy host data, and a replay would keep it")


class Reads:
    """The parameters (persistable Tensors) a capture's ops read, with
    the storage each was read at: a replay reads those addresses, so a
    parameter rebound since (``set_value``, ``set_state_dict``, an
    update op's output) makes its owner capture again."""

    def __init__(self):
        self.seen: Dict[int, tuple] = {}

    def __call__(self, in_tensors) -> None:
        for ts in in_tensors.values():
            for t in ts:
                if t.persistable and id(t) not in self.seen:
                    self.seen[id(t)] = (t, t._value, t._value.data_ptr())

    def current(self) -> bool:
        return all(t._value is v and v.data_ptr() == ptr
                   for t, v, ptr in self.seen.values())


class Unit:
    """One compiled unit: a ``to_static`` cache entry. It holds the
    unit's constants and loop bodies and counts what its Python met:
    ``tensor_ifs`` and ``tensor_loops`` (at the function level),
    ``selects`` (tensor ifs inside captured loop bodies), ``host_reads``
    (device-to-host reads of conditions) and ``trips``."""

    def __init__(self, device: torch.device, name: str):
        self.device = torch.device(device)
        self.name = name
        self.constants = Constants()
        self.loops: "collections.OrderedDict[tuple, _LoopBody]" = (
            collections.OrderedDict())
        # per loop: {carry index: (shape, dtype, device)} of loop-locals
        self.seeds: Dict[tuple, Dict[int, tuple]] = {}
        self.loop_entries = 0  # tensor loops entered, in every call
        self.counts = {"tensor_ifs": 0, "tensor_loops": 0, "selects": 0,
                       "host_reads": 0, "trips": 0, "loop_captures": 0}


class _Scope:
    """What runs now: ``unit``'s Python in ``mode`` "warm" (an eager run
    before a capture), "capture", or "op" (the loop route, op by op);
    ``body`` when it is a loop body's."""

    def __init__(self, unit: Unit, mode: str, body: bool):
        self.unit, self.mode, self.body = unit, mode, body
        self.nested_loop = False  # a tensor loop met inside a loop body


_STACK: List[_Scope] = []


def current() -> Optional[_Scope]:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def compiling(unit: Unit, mode: str, body: bool = False,
              reads: Optional[Reads] = None):
    """Run ``unit``'s Python in ``mode`` (see :class:`_Scope`): no tape,
    host reads of tensors refused, host constants through the unit's
    :class:`Constants` (recorded at a warm-up, taken at a capture), and
    ``reads`` observing the parameters the ops read."""
    scope = _Scope(unit, mode, body)
    tracer = _framework._current_tracer()
    saved = (_varbase._compiled, _varbase._constants,
             unit.constants.capturing)
    grad = tracer.enable_grad if tracer is not None else None
    _STACK.append(scope)
    _varbase._compiled = host_read_refused
    _varbase._constants = unit.constants
    unit.constants.capturing = mode == "capture"
    if tracer is not None:
        tracer.enable_grad = False
        if reads is not None:
            tracer.observers.append(reads)
    try:
        yield scope
    finally:
        _STACK.pop()
        (_varbase._compiled, _varbase._constants,
         unit.constants.capturing) = saved
        if tracer is not None:
            tracer.enable_grad = grad
            if reads is not None:
                tracer.observers.remove(reads)


def _read(t: Tensor) -> bool:
    """A condition's value on the host (the converters' own read, allowed
    where the user's is refused), counted on the running unit."""
    scope = current()
    if scope is not None:
        scope.unit.counts["host_reads"] += 1
    return bool(core.host_numpy(t._value))


# ---------------------------------------------------------------------------
# runtime converters (reference convert_operators.py)
# ---------------------------------------------------------------------------


def _is_traced(x) -> bool:
    """A Tensor met inside a compiled unit: its value is not concrete."""
    return isinstance(x, Tensor) and bool(_STACK)


class _Undefined:
    """Placeholder for a name assigned only inside one branch and never
    defined before the `if` (the reference's UndefinedVar)."""

    def __repr__(self):
        return "<undefined local (assigned in only one to_static branch)>"


UNDEF = _Undefined()


def grab(lcls, names):
    """Fetch current values of `names` for branch-fn arguments; missing
    names get the UNDEF sentinel."""
    return tuple(lcls.get(n, UNDEF) for n in names)


_PY_DTYPES = ((bool, torch.bool), (int, torch.int64), (float, torch.float32))


def _py_dtype(v) -> Optional[torch.dtype]:
    for kind, dtype in _PY_DTYPES:
        if isinstance(v, kind):
            return dtype
    return None


def _as_tensor(v, device, like: Optional[torch.Tensor] = None):
    """``v`` as a Tensor: a Python number as a 0-d tensor (of ``like``'s
    dtype when given) filled on the device, as ``lax.cond`` makes an
    array of a Python branch output; anything else unchanged."""
    if isinstance(v, Tensor) or _py_dtype(v) is None:
        return v
    dtype = like.dtype if like is not None else _py_dtype(v)
    return Tensor._wrap(torch.full((), v, dtype=dtype, device=device))


def _no_undef(out) -> tuple:
    if not isinstance(out, tuple):
        out = (out,)
    if any(isinstance(o, _Undefined) for o in out):
        # a name assigned in only ONE branch and never defined before the
        # `if` leaks the sentinel out of the other branch
        raise Dy2StaticError(
            "to_static: a variable assigned in only one branch of "
            "a tensor-dependent `if` has no value on the other "
            "path; initialize it before the branch")
    return out


def _select(pred: Tensor, t_out, f_out) -> tuple:
    """Each output of two branches picked on the device by ``pred``."""
    t_out, f_out = _no_undef(t_out), _no_undef(f_out)
    p = pred._value.reshape(()).to(torch.bool)
    out = []
    for a, b in zip(t_out, f_out):
        a_t = a._value if isinstance(a, Tensor) else None
        b_t = b._value if isinstance(b, Tensor) else None
        a = _as_tensor(a, p.device, b_t)
        b = _as_tensor(b, p.device, a_t)
        if not (isinstance(a, Tensor) and isinstance(b, Tensor)):
            raise Dy2StaticError(
                f"to_static: a tensor-dependent `if` inside a loop gives "
                f"{a!r} and {b!r}, which are not tensors")
        if a.shape != b.shape or a.dtype != b.dtype:
            raise Dy2StaticError(
                f"to_static: the branches of a tensor-dependent `if` give "
                f"a value of {a.shape} {a.dtype} and one of {b.shape} "
                f"{b.dtype}; both branches must agree")
        out.append(Tensor._wrap(torch.where(p, a._value, b._value)))
    return tuple(out)


def convert_ifelse(pred, true_fn, false_fn, args=()):
    """Branch fns take the assigned names positionally (pre-`if` values or
    UNDEF) and return the same tuple of assigned names."""
    scope = current()
    if scope is None or not isinstance(pred, Tensor):
        if isinstance(pred, Tensor):
            pred = bool(pred.numpy())
        return true_fn(*args) if pred else false_fn(*args)
    if scope.body:
        scope.unit.counts["selects"] += 1
        return _select(pred, true_fn(*args), false_fn(*args))
    if scope.mode == "capture":
        raise Dy2StaticError(
            f"to_static: {scope.unit.name} met a tensor-dependent `if` "
            f"while it was captured, but not in its warm-up run")
    scope.unit.counts["tensor_ifs"] += 1
    out = _no_undef((true_fn if _read(pred) else false_fn)(*args))
    return tuple(_as_tensor(o, pred.place) for o in out)


def convert_while_loop(cond_fn, body_fn, loop_vars: tuple):
    """cond_fn/body_fn take the loop-carried names positionally; body
    returns them as a tuple. Carries undefined before the loop arrive as
    UNDEF: fine on the Python path (they error naturally if read); on the
    loop route a trip that carries one runs op by op. A condition that
    turns into a tensor after Python trips (a break flag a tensor `if`
    set) takes the loop route from there."""
    scope = current()
    vals, c = tuple(loop_vars), cond_fn(*loop_vars)
    while True:
        if isinstance(c, Tensor):
            if scope is not None:
                return _tensor_loop(scope, cond_fn, body_fn, vals, c)
            c = bool(c.numpy())
        if not c:
            return vals
        vals = _as_tuple(body_fn(*vals))
        c = cond_fn(*vals)


def _tensor_loop(scope: "_Scope", cond_fn, body_fn, loop_vars, probe):
    """The loop route (see the module docstring) from ``loop_vars``, whose
    condition ``probe`` is a tensor."""
    unit = scope.unit
    if scope.mode == "capture":
        raise Dy2StaticError(
            f"to_static: {unit.name} met a tensor-dependent loop while it "
            f"was captured, but not in its warm-up run")
    if scope.body:
        # a tensor loop inside a loop body: that body runs op by op
        scope.nested_loop = True
        return _op_loop(cond_fn, body_fn, loop_vars, probe)
    unit.counts["tensor_loops"] += 1
    unit.loop_entries += 1
    entry = unit.loop_entries
    vals = [_as_tensor(v, probe.place) for v in loop_vars]
    # a loop-local name (unassigned before the loop) starts as zeros of
    # what an earlier trip assigned it, as the JAX package seeds it, so
    # that the first trip too can replay the body
    seeds = unit.seeds.setdefault((body_fn.__code__, cond_fn.__code__), {})
    for i, v in enumerate(vals):
        if isinstance(v, _Undefined) and i in seeds:
            shape, dtype, device = seeds[i]
            vals[i] = Tensor._wrap(torch.zeros(shape, dtype=dtype,
                                               device=device))
    pred, owner = probe, None
    while _read(pred):
        unit.counts["trips"] += 1
        owner = _loop_body(unit, cond_fn, body_fn, vals)
        if owner is None:
            undef = [i for i, v in enumerate(vals)
                     if isinstance(v, _Undefined)]
            vals = list(_as_tuple(body_fn(*vals)))
            for i in undef:
                if isinstance(vals[i], Tensor):
                    seeds[i] = (vals[i].shape, vals[i].dtype, vals[i].place)
            pred = cond_fn(*vals)
            continue
        vals, pred = owner.trip(vals, cond_fn, body_fn, entry)
    # carries left in a body's buffers are copied out: the next trip of
    # that body, in this call or a later one, overwrites them
    return tuple(Tensor._wrap(v._value.clone(), v.stop_gradient)
                 if owner is not None and owner.owns(v) else v
                 for v in vals)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _op_loop(cond_fn, body_fn, vals, pred) -> tuple:
    vals = tuple(vals)
    while _read(pred):
        vals = _as_tuple(body_fn(*vals))
        pred = cond_fn(*vals)
    return vals


def _cells(*fns):
    """The closure cells of ``fns`` (what a loop body reads from the
    enclosing function), each once, by name."""
    out = {}
    for fn in fns:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
            out.setdefault(name, cell)
    return sorted(out.items())


def _cell_key(cell) -> tuple:
    try:
        v = cell.cell_contents
    except ValueError:
        return ("empty",)
    if isinstance(v, Tensor):
        return ("tensor", v.shape, v.dtype, v.place)
    if v is None or isinstance(v, (bool, int, float, str)):
        return ("value", type(v).__name__, v)
    if inspect.isfunction(v):
        return ("function", v.__code__)
    return ("object", id(v))


def _loop_body(unit: Unit, cond_fn, body_fn, vals) -> Optional["_LoopBody"]:
    """The unit's loop body for these carries and closure (made on first
    use), or None where a carry is not a tensor."""
    if not all(isinstance(v, Tensor) for v in vals):
        return None
    cells = _cells(body_fn, cond_fn)
    key = (body_fn.__code__, cond_fn.__code__,
           tuple((v.shape, v.dtype, v.place) for v in vals),
           tuple((n, _cell_key(c)) for n, c in cells))
    body = unit.loops.get(key)
    if body is None:
        body = _LoopBody(unit, vals, cells)
        unit.loops[key] = body
        while len(unit.loops) > _MAX_LOOP_BODIES:
            unit.loops.popitem(last=False)
    unit.loops.move_to_end(key)
    return body


class _LoopBody:
    """One loop body and the next trip's condition as a
    ``replay.Captured`` graph over static buffers: ``carries`` (read at
    the start of a trip and overwritten with the trip's results, inside
    the graph) and ``cells`` (the closure's tensors, copied in once each
    time the loop is entered: a name the body only reads may be rebound
    between two runs of the loop in one call). ``unstable`` (a trip
    changed a carry's shape or dtype) and ``op_by_op`` (a tensor loop
    inside the body) run each trip eagerly."""

    def __init__(self, unit: Unit, vals, cells):
        self.unit = unit
        self.carries = [torch.empty_like(v._value) for v in vals]
        self.grads = [v.stop_gradient for v in vals]
        self.cell_names = [n for n, c in cells
                           if isinstance(_contents(c), Tensor)]
        self.cell_bufs = {n: torch.empty_like(_contents(c)._value)
                          for n, c in cells if n in self.cell_names}
        self.reads = Reads()
        self.run = _replay.Captured(self._body, unit.device, warmup=1)
        self.unstable = self.op_by_op = False
        self.filled = -1  # the loop entry whose closure is in cell_bufs
        self.fns = None
        self.outs: Optional[list] = None

    def trip(self, vals, cond_fn, body_fn, entry: int):
        """Run one trip from ``vals`` of the loop entered ``entry``-th:
        (the carries, the next condition)."""
        cells = dict(_cells(body_fn, cond_fn))
        self.fns = (cond_fn, body_fn, cells)
        if self.unstable:
            out = _as_tuple(body_fn(*vals))
            return list(out), cond_fn(*out)
        if entry != self.filled:
            for n in self.cell_names:
                self.cell_bufs[n].copy_(cells[n].cell_contents._value)
            self.filled = entry
        for buf, v in zip(self.carries, vals):
            if v._value is not buf:
                buf.copy_(v._value)
        if self.run.captured and not self.reads.current():
            self.run = _replay.Captured(self._body, self.unit.device,
                                        warmup=0)
            self.reads = Reads()
        if self.op_by_op:
            pred = self._body(False)
        else:
            pred, phase = self.run()
            if phase == "capture":
                self.unit.counts["loop_captures"] += 1
        if pred is None:  # the warm-up trip changed a shape or dtype
            out = self.outs
            self.outs = None
            return out, cond_fn(*out)
        return ([Tensor._wrap(buf, g) for buf, g in zip(self.carries,
                                                        self.grads)],
                Tensor._wrap(pred))

    def owns(self, v) -> bool:
        return isinstance(v, Tensor) and any(v._value is b
                                             for b in self.carries)

    def _body(self, replayed: bool):
        cond_fn, body_fn, cells = self.fns
        vals = [Tensor._wrap(b, g) for b, g in zip(self.carries, self.grads)]
        held = {n: cells[n].cell_contents for n in self.cell_names}
        for n in self.cell_names:
            cells[n].cell_contents = Tensor._wrap(self.cell_bufs[n],
                                                  held[n].stop_gradient)
        try:
            with compiling(self.unit, "capture" if replayed else "warm",
                           body=True,
                           reads=self.reads if replayed else None) as scope:
                out = _as_tuple(body_fn(*vals))
                pred = cond_fn(*out)
        finally:
            for n in self.cell_names:
                cells[n].cell_contents = held[n]
        if scope.nested_loop:
            self.op_by_op = True
        same = all(isinstance(o, Tensor) and o.shape == tuple(b.shape)
                   and o.dtype == b.dtype for o, b in zip(out, self.carries))
        if not same:
            if replayed:
                raise Dy2StaticError(
                    f"to_static: a loop of {self.unit.name} changed a "
                    f"carried value's shape or dtype while it was captured")
            self.unstable = True
            self.outs = list(out)
            return None
        if isinstance(pred, Tensor):
            pred = pred._value.reshape(()).to(torch.bool)
        else:
            pred = torch.full((), bool(pred), device=self.unit.device)
        # the results become the next trip's carries; a result that is
        # (a view of) another carry's buffer is copied out first
        ptrs = {b.untyped_storage().data_ptr() for b in self.carries}
        src = []
        for o, buf in zip(out, self.carries):
            v = o._value
            if v is not buf and v.untyped_storage().data_ptr() in ptrs:
                v = v.clone()
            src.append(v)
        for v, buf in zip(src, self.carries):
            if v is not buf:
                buf.copy_(v)
        return pred


def _contents(cell):
    try:
        return cell.cell_contents
    except ValueError:
        return None


def range_cond(i, stop, step):
    """Direction-aware desugared-range condition: i < stop for positive
    step, i > stop for negative (sign decided by the CONCRETE step when
    available; a traced step uses sign-folded arithmetic)."""
    if not _is_traced(step):
        sv = float(step.numpy()) if isinstance(step, Tensor) else float(step)
        return (i < stop) if sv > 0 else (i > stop)
    # traced step: (stop - i) * sign(step) > 0 covers both directions
    return (stop - i) * step > 0


def cf_not(a):
    """Tensor-aware logical not (Tensor / python bool)."""
    if isinstance(a, Tensor):
        return Tensor._wrap(torch.logical_not(a._value))
    return not a


def cf_and(a, b):
    if isinstance(a, Tensor) or isinstance(b, Tensor):
        return _both(torch.logical_and, a, b)
    return a and b


def cf_or(a, b):
    if isinstance(a, Tensor) or isinstance(b, Tensor):
        return _both(torch.logical_or, a, b)
    return a or b


def _both(fn, a, b) -> Tensor:
    """``fn`` of a Tensor and a Tensor or Python value; the Python value
    stays a scalar argument (no host-to-device copy)."""
    if not isinstance(a, Tensor):
        a, b = b, a
    if isinstance(b, Tensor):
        return Tensor._wrap(fn(a._value, b._value))
    return Tensor._wrap(fn(a._value, torch.full((), bool(b),
                                                  device=a._value.device)))


def cf_live(*flags):
    """True while no interrupt flag (break/continue/return) is set —
    the guard condition the desugarer wraps trailing statements in."""
    live = True
    for f in flags:
        live = cf_and(live, cf_not(f))
    return live


def select_return(flag, ret_val, fallthrough_val):
    """Merge a return-from-loop with the function's trailing return:
    where(flag, loop_ret, fallthrough) over matching values (the
    reference ReturnTransformer's select on return flags)."""
    if not isinstance(flag, Tensor):
        return ret_val if flag else fallthrough_val
    a = _as_tuple(ret_val)
    b = _as_tuple(fallthrough_val)
    if len(a) != len(b):
        raise Dy2StaticError(
            "to_static: the value returned from inside a tensor loop and "
            "the function's trailing return have different structures "
            f"({len(a)} vs {len(b)} values); make them match")
    out = _select(flag, a, b)
    return out if isinstance(ret_val, tuple) else out[0]


def assert_plain(value, construct: str):
    """Loud failure when a construct the transpiler does not support turns
    out to be tensor-dependent (the reference raises through its
    transformer for the same cases)."""
    if _is_traced(value):
        raise Dy2StaticError(
            f"to_static: {construct} with a tensor-dependent condition is "
            f"not supported by the AST transpiler; rewrite with "
            f"paddle.static.nn.cond/while_loop or hoist the condition out "
            f"of the traced function"
        )
    return value


# ---------------------------------------------------------------------------
# the source transform (reference loop_transformer / ifelse_transformer)
# ---------------------------------------------------------------------------


class _Names(ast.NodeVisitor):
    def __init__(self):
        self.stored: List[str] = []
        self.loaded: List[str] = []

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            if node.id not in self.stored:
                self.stored.append(node.id)
        else:
            if node.id not in self.loaded:
                self.loaded.append(node.id)
        self.generic_visit(node)


def _names(nodes) -> _Names:
    v = _Names()
    for n in nodes if isinstance(nodes, list) else [nodes]:
        v.visit(n)
    return v


def _has(nodes, *types) -> bool:
    for n in nodes if isinstance(nodes, list) else [nodes]:
        for sub in ast.walk(n):
            if isinstance(sub, types):
                return True
    return False


_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.While,
                   ast.For, ast.AsyncFor, ast.Lambda)


def _has_interrupts(stmts, types) -> bool:
    """Like _has but does NOT descend into nested loops/functions: their
    break/continue/return bind to the inner scope, not this loop."""
    def walk(n):
        if isinstance(n, tuple(types)):
            return True
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _SCOPE_BARRIERS):
                continue
            if walk(child):
                return True
        return False

    return any(
        walk(s)
        for s in (stmts if isinstance(stmts, list) else [stmts])
        # a statement that IS a nested loop/function owns its interrupts
        if not isinstance(s, _SCOPE_BARRIERS)
    )


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0
        self._fn_depth = 0

    # only transform the top-level function's body (nested defs are the
    # hoisted helpers or user closures — leave them)
    def visit_FunctionDef(self, node):
        self._fn_depth += 1
        if self._fn_depth == 1:
            node.body = [self.visit(n) for n in node.body]
            node.body = _flatten_stmts(node.body)
            node.body = _merge_return_markers(node.body)
            # markers that did NOT land in the top-level body (the loop
            # sat inside an if/with): guard them so a traced flag raises
            # a Dy2StaticError instead of bool()-ing a tracer
            for sub in ast.walk(node):
                if getattr(sub, "_pt_ret_marker", None) is not None \
                        and isinstance(sub, ast.If):
                    sub._pt_ret_marker = None
                    sub.test = _call("assert_plain", [sub.test, ast.Constant(
                        "return inside a tensor loop that is not directly "
                        "in the function body")])
        self._fn_depth -= 1
        return node

    def _fresh(self, kind):
        self.counter += 1
        return f"_pt_{kind}_{self.counter}"

    def visit_While(self, node):
        if _has_interrupts(node.body, (ast.Yield,)):
            node = _generic_visit_block(self, node)
            node.test = _call("assert_plain", [node.test, ast.Constant(
                "while loop containing yield")])
            return node
        if _has_interrupts(node.body,
                           (ast.Break, ast.Continue, ast.Return)):
            # desugar to flag variables + guard-ifs BEFORE visiting
            # children, so `if tensor_cond: break` becomes an assignment
            # branch visit_If can convert (reference
            # break_continue_transformer.py / return_transformer.py);
            # the rewritten loop re-enters with no interrupts left
            pre, node, tail = self._desugar_interrupts(node)
            out = self.visit_While(node)
            if not isinstance(out, list):
                out = [out]
            return pre + out + tail
        node = _generic_visit_block(self, node)
        body_n = _names(node.body)
        cond_n = _names(node.test)
        # ALL names the body assigns are carried (a name read only AFTER
        # the loop must still flow out); initials come from grab() so
        # not-yet-defined ones start as UNDEF (loud error if traced)
        carried = sorted(set(body_n.stored)) or ["_pt_dummy"]
        cname = self._fresh("while_cond")
        bname = self._fresh("while_body")
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in carried],
            kwonlyargs=[], kw_defaults=[], defaults=[],
        )
        cond_def = ast.FunctionDef(
            name=cname, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[],
        )
        body_def = ast.FunctionDef(
            name=bname, args=args,
            body=list(node.body) + [ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in carried],
                ctx=ast.Load()))],
            decorator_list=[],
        )
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in carried],
                ctx=ast.Store())],
            value=_call("convert_while_loop", [
                ast.Name(id=cname, ctx=ast.Load()),
                ast.Name(id=bname, ctx=ast.Load()),
                _call("grab", [
                    ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                             args=[], keywords=[]),
                    ast.List(elts=[ast.Constant(n) for n in carried],
                             ctx=ast.Load()),
                ]),
            ]),
        )
        return [cond_def, body_def, assign]

    def _desugar_interrupts(self, node):
        """Rewrite break/continue/return in `node.body` into flag
        assignments; wrap statements after an interrupt point in
        `if cf_live(flags):` guards (converted by visit_If, so tensor
        flags work); strengthen the loop test with `not break_flag`.
        Returns (pre_stmts, rewritten_while, tail_stmts)."""
        k = self.counter = self.counter + 1
        brk = f"_pt_brk_{k}"
        cont = f"_pt_cont_{k}"
        retf = f"_pt_retf_{k}"
        retv = f"_pt_retv_{k}"
        has_ret = _has_interrupts(node.body, (ast.Return,))
        has_cont = _has_interrupts(node.body, (ast.Continue,))

        def false_assign(name):
            return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                              value=ast.Constant(False))

        def true_assign(name):
            return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                              value=ast.Constant(True))

        def rewrite_one(st):
            """-> (replacement stmts, interrupts?)"""
            if isinstance(st, ast.Break):
                return [true_assign(brk)], True
            if isinstance(st, ast.Continue):
                return [true_assign(cont)], True
            if isinstance(st, ast.Return):
                val = st.value or ast.Constant(None)
                return [
                    true_assign(brk), true_assign(retf),
                    ast.Assign(targets=[ast.Name(id=retv, ctx=ast.Store())],
                               value=val),
                ], True
            if isinstance(st, ast.If):
                b, bi = rewrite_list(st.body)
                o, oi = rewrite_list(st.orelse)
                st.body = b or [ast.Pass()]
                st.orelse = o
                return [st], bi or oi
            if isinstance(st, ast.With):
                b, bi = rewrite_list(st.body)
                st.body = b or [ast.Pass()]
                return [st], bi
            if isinstance(st, ast.Try):
                hit = False
                for attr in ("body", "orelse", "finalbody"):
                    lst, h = rewrite_list(getattr(st, attr))
                    setattr(st, attr, lst or ([ast.Pass()] if attr == "body" else []))
                    hit = hit or h
                for handler in st.handlers:
                    lst, h = rewrite_list(handler.body)
                    handler.body = lst or [ast.Pass()]
                    hit = hit or h
                return [st], hit
            # nested loops / function defs own their interrupts
            return [st], False

        def rewrite_list(stmts):
            out = []
            hit = False
            for i, st in enumerate(stmts):
                rep, interrupts = rewrite_one(st)
                out.extend(rep)
                if interrupts:
                    hit = True
                    rest, rest_hit = rewrite_list(stmts[i + 1:])
                    if rest:
                        flags = [ast.Name(id=brk, ctx=ast.Load())]
                        if has_cont:
                            flags.append(ast.Name(id=cont, ctx=ast.Load()))
                        out.append(ast.If(test=_call("cf_live", flags),
                                          body=rest, orelse=[]))
                    break
            return out, hit

        new_body, _ = rewrite_list(list(node.body))
        if has_cont:
            new_body = [false_assign(cont)] + new_body
        suffix = list(getattr(node, "_pt_unguarded_suffix", ()))
        if suffix:
            # the for-range increment: runs on `continue` (python advances
            # the iterator) but NOT once `break`/`return` fired
            new_body.append(ast.If(
                test=_call("cf_live", [ast.Name(id=brk, ctx=ast.Load())]),
                body=suffix, orelse=[]))
        node.body = new_body
        node.test = _call("cf_and", [
            _call("cf_not", [ast.Name(id=brk, ctx=ast.Load())]), node.test,
        ])
        pre = [false_assign(brk)]
        if has_cont:
            pre.append(false_assign(cont))
        tail = []
        if has_ret:
            pre += [false_assign(retf),
                    ast.Assign(targets=[ast.Name(id=retv, ctx=ast.Store())],
                               value=ast.Constant(0.0))]
            ret_if = ast.If(
                test=ast.Name(id=retf, ctx=ast.Load()),
                body=[ast.Return(value=ast.Name(id=retv, ctx=ast.Load()))],
                orelse=[],
            )
            ret_if._pt_ret_marker = (retf, retv)
            tail.append(ret_if)
        return pre, node, tail

    def visit_For(self, node):
        # for i in range(...) -> while desugar; anything else gets a guard
        is_range = (
            isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and isinstance(node.target, ast.Name)
            and not node.orelse
        )
        if not is_range or _has_interrupts(node.body, (ast.Yield,)):
            node = _generic_visit_block(self, node)
            if is_range or isinstance(node.iter, (ast.Call, ast.Name, ast.Attribute)):
                node.iter = _call("assert_plain", [node.iter, ast.Constant(
                    "for loop (non-range iterable or yield inside)")])
            return node
        if not _has_interrupts(node.body, (ast.Break, ast.Continue,
                                           ast.Return)):
            node = _generic_visit_block(self, node)
        rargs = node.iter.args
        start = rargs[0] if len(rargs) >= 2 else ast.Constant(0)
        stop = rargs[1] if len(rargs) >= 2 else rargs[0]
        step = rargs[2] if len(rargs) >= 3 else ast.Constant(1)
        i = node.target.id
        step_name = self._fresh("range_step")
        init = ast.Assign(targets=[ast.Name(id=i, ctx=ast.Store())], value=start)
        step_init = ast.Assign(
            targets=[ast.Name(id=step_name, ctx=ast.Store())], value=step)
        incr = ast.Assign(
            targets=[ast.Name(id=i, ctx=ast.Store())],
            value=ast.BinOp(left=ast.Name(id=i, ctx=ast.Load()),
                            op=ast.Add(),
                            right=ast.Name(id=step_name, ctx=ast.Load())),
        )
        has_interrupts = _has_interrupts(
            node.body, (ast.Break, ast.Continue, ast.Return))
        loop = ast.While(
            test=_call("range_cond", [
                ast.Name(id=i, ctx=ast.Load()), stop,
                ast.Name(id=step_name, ctx=ast.Load())]),
            # with interrupts, the increment rides OUTSIDE the guard
            # blocks (python `continue` in a for still advances i)
            body=(list(node.body) if has_interrupts
                  else list(node.body) + [incr]),
            orelse=[],
        )
        if has_interrupts:
            loop._pt_unguarded_suffix = [incr]
        out = self.visit_While(loop)
        if not isinstance(out, list):
            out = [out]
        return [init, step_init] + out

    def visit_If(self, node):
        node = _generic_visit_block(self, node)
        if _has(node.body + node.orelse, ast.Break, ast.Continue,
                ast.Return, ast.Yield):
            node.test = _call("assert_plain", [node.test, ast.Constant(
                "if containing return/break/continue")])
            return node
        assigned = sorted(set(_names(node.body).stored)
                          | set(_names(node.orelse).stored))
        if not assigned:
            # side-effect-only branches: keep Python `if` but guard
            node.test = _call("assert_plain", [node.test, ast.Constant(
                "if with no assigned variables (side effects only)")])
            return node
        tname = self._fresh("if_true")
        fname = self._fresh("if_false")
        brargs = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in assigned],
            kwonlyargs=[], kw_defaults=[], defaults=[],
        )
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in assigned],
            ctx=ast.Load()))
        t_def = ast.FunctionDef(name=tname, args=brargs,
                                body=list(node.body) + [ret], decorator_list=[])
        f_def = ast.FunctionDef(name=fname, args=brargs,
                                body=(list(node.orelse) or [ast.Pass()]) + [ret],
                                decorator_list=[])
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=_call("convert_ifelse", [
                node.test,
                ast.Name(id=tname, ctx=ast.Load()),
                ast.Name(id=fname, ctx=ast.Load()),
                _call("grab", [
                    ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                             args=[], keywords=[]),
                    ast.List(elts=[ast.Constant(n) for n in assigned],
                             ctx=ast.Load()),
                ]),
            ]),
        )
        return [t_def, f_def, assign]


def _merge_return_markers(body):
    """A return-from-loop leaves a marker `if _pt_retf: return _pt_retv`
    after the converted loop. When it's followed by nothing or a single
    trailing `return expr`, merge into one traced-safe select
    (select_return). Any other shape keeps the python `if` with a loud
    guard on traced flags (the eager path still works)."""
    out = []
    for idx, st in enumerate(body):
        marker = getattr(st, "_pt_ret_marker", None)
        if marker is None:
            out.append(st)
            continue
        retf, retv = marker
        rest = body[idx + 1:]
        if not rest or (len(rest) == 1 and isinstance(rest[0], ast.Return)):
            fall = (rest[0].value if rest else None) or ast.Constant(None)
            out.append(ast.Return(value=_call("select_return", [
                ast.Name(id=retf, ctx=ast.Load()),
                ast.Name(id=retv, ctx=ast.Load()),
                fall,
            ])))
            return out
        st.test = _call("assert_plain", [st.test, ast.Constant(
            "return inside a tensor loop not followed by a plain return")])
        out.append(st)
    return out


def _generic_visit_block(tr, node):
    node.body = _flatten_stmts([tr.visit(n) for n in node.body])
    if hasattr(node, "orelse"):
        node.orelse = _flatten_stmts([tr.visit(n) for n in node.orelse])
    return node


def _flatten_stmts(stmts):
    out = []
    for s in stmts:
        if isinstance(s, list):
            out.extend(s)
        else:
            out.append(s)
    return out


def _call(helper, args):
    return ast.Call(
        func=ast.Attribute(
            value=ast.Name(id="_pt_dy2st", ctx=ast.Load()),
            attr=helper, ctx=ast.Load()),
        args=args, keywords=[],
    )


@functools.lru_cache(maxsize=256)
def _transform_cached(fn_key, source, filename):
    tree = ast.parse(source)
    fndef = tree.body[0]
    fndef.decorator_list = []  # drop @to_static etc.
    new = _ControlFlowTransformer().visit(tree)
    ast.fix_missing_locations(new)
    return compile(new, filename=f"<dy2static {filename}>", mode="exec")


def ast_transform(fn: Callable) -> Callable:
    """Return fn with tensor-dependent control flow rewritten through the
    runtime converters. Raises Dy2StaticError when the source is
    unavailable (builtins, lambdas)."""
    try:
        source = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise Dy2StaticError(
            f"to_static AST transform needs the function source: {e}"
        )
    if source.lstrip().startswith("lambda"):
        raise Dy2StaticError("to_static cannot transform lambdas")
    code = _transform_cached(
        f"{fn.__module__}.{fn.__qualname__}", source,
        getattr(fn, "__code__", None) and fn.__code__.co_filename or "<src>",
    )
    import sys

    this = sys.modules[__name__]

    class _LiveGlobals(dict):
        """Overlay globals: converter + closure bindings here, everything
        else resolved in the LIVE module globals at lookup time — a
        snapshot copy would freeze the module (helpers defined below the
        decorated function, later monkeypatches would vanish)."""

        def __init__(self, live, extra):
            super().__init__(extra)
            self._live = live

        def __missing__(self, key):
            return self._live[key]  # KeyError -> NameError, as normal

    extra: Dict[str, Any] = {"_pt_dy2st": this}
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                extra[name] = cell.cell_contents
            except ValueError:
                pass
    glb = _LiveGlobals(fn.__globals__, extra)
    ns: Dict[str, Any] = {}
    exec(code, glb, ns)
    new_fn = ns[fn.__name__]
    new_fn.__wrapped_original__ = fn
    return new_fn
