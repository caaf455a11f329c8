"""Program/Block/Operator/Variable graph builder, with plain-Python descs.

Port of ``paddle_tpu/framework/program.py``. The JAX package keeps every
desc in generated protobuf classes (``paddle_tpu/proto/framework_pb2``);
the port's descs are small Python classes with the same fields as
``proto/framework.proto`` (:class:`VarDesc`, :class:`OpDesc`,
:class:`BlockDesc`; a Program is its list of blocks), so the port needs
no protobuf package. ``clone()`` copies descs instead of round-tripping
bytes; ``serialize_to_string``/``parse_from_string`` write and read the
``framework.proto`` wire format through ``_proto.py``, so a program
serialized by either package parses in the other.

Output shapes and dtypes are inferred when an op is appended, by running
the op's lowering on ``meta`` tensors (``registry.infer_op``).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import flags as _flags
from . import _proto, core, unique_name
from . import errors as _errs

__all__ = ["VarDesc", "OpDesc", "BlockDesc", "Variable",
           "Parameter", "Operator", "Block", "Program", "device_guard",
           "program_guard", "default_main_program",
           "default_startup_program", "switch_main_program",
           "switch_startup_program", "in_dygraph_mode"]

DENSE_TENSOR = "dense_tensor"

# ---------------------------------------------------------------------------
# global mode switch: the dygraph tracer when eager mode is on, else None
# (static graph building)
# ---------------------------------------------------------------------------

_dygraph_tracer_ = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer_ is not None


def _current_tracer():
    return _dygraph_tracer_


def _switch_tracer(tracer):
    """Make ``tracer`` the active one (None: static mode); returns the
    previous one."""
    global _dygraph_tracer_
    old = _dygraph_tracer_
    _dygraph_tracer_ = tracer
    return old


_current_device_guard: Optional[str] = None


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    """Tag ops appended in this scope with ``op_device`` (the pipeline
    stage marker of the JAX package; the port runs no pipeline and only
    records the tag)."""
    global _current_device_guard
    prev = _current_device_guard
    _current_device_guard = device
    try:
        yield
    finally:
        _current_device_guard = prev


# ---------------------------------------------------------------------------
# descs (the fields of proto/framework.proto, as plain Python)
# ---------------------------------------------------------------------------


def _attr_value(value: Any) -> Any:
    """Normalize an attr the way a protobuf round trip would: bools,
    ints, floats and strings as Python scalars, sequences as lists, a
    Block as its index."""
    if isinstance(value, bool):
        return value
    if isinstance(value, Block):
        return value.idx
    if isinstance(value, int) or (hasattr(value, "dtype") and hasattr(
            value, "item") and getattr(value, "ndim", 1) == 0):
        item = value.item() if hasattr(value, "item") else value
        if isinstance(item, bool):
            return item
        return int(item) if isinstance(item, int) else float(item)
    if isinstance(value, float):
        return float(value)
    if isinstance(value, str):
        return value
    if isinstance(value, (list, tuple)):
        return [_attr_value(v) for v in value]
    raise _errs.errors.InvalidArgument(f"unsupported attr value: {value!r}")


class VarDesc:
    """``VarDesc``: name, type, dtype name, dims, persistable,
    stop_gradient, is_parameter, need_check_feed and the sharding
    annotation ``dims_mapping`` (carried, unused by the port)."""

    __slots__ = ("name", "type", "dtype", "dims", "persistable",
                 "stop_gradient", "is_parameter", "need_check_feed",
                 "dims_mapping")

    def __init__(self, name: str, dtype: str = "float32",
                 dims: Sequence[int] = (), type: str = DENSE_TENSOR,
                 persistable: bool = False, stop_gradient: bool = False,
                 is_parameter: bool = False, need_check_feed: bool = False):
        self.name = name
        self.type = type
        self.dtype = dtype
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_parameter = is_parameter
        self.need_check_feed = need_check_feed
        self.dims_mapping: Tuple[str, ...] = ()

    def copy(self) -> "VarDesc":
        return copy.copy(self)


class OpDesc:
    """``OpDesc``: type, inputs and outputs as ordered (parameter,
    arguments) pairs, attrs as name -> value. ``attr_types`` keeps the
    ``AttrType`` of an attr whose value alone would type otherwise (a
    block index, or a parsed LONG, FLOAT or empty list; ``_proto.py``)."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "attr_types")

    def __init__(self, type: str):
        self.type = type
        self.inputs: List[Tuple[str, List[str]]] = []
        self.outputs: List[Tuple[str, List[str]]] = []
        self.attrs: Dict[str, Any] = {}
        self.attr_types: Dict[str, int] = {}

    def copy(self) -> "OpDesc":
        d = OpDesc(self.type)
        d.inputs = [(p, list(a)) for p, a in self.inputs]
        d.outputs = [(p, list(a)) for p, a in self.outputs]
        d.attrs = copy.deepcopy(self.attrs)
        d.attr_types = dict(self.attr_types)
        return d

    def set_attr(self, name: str, value: Any) -> None:
        """Store ``value`` normalized (``_attr_value``); a Block, or a list
        of them, keeps its BLOCK / BLOCKS type."""
        self.attrs[name] = _attr_value(value)
        self.attr_types.pop(name, None)
        if isinstance(value, Block):
            self.attr_types[name] = _proto.BLOCK
        elif (isinstance(value, (list, tuple)) and value
              and isinstance(value[0], Block)):
            self.attr_types[name] = _proto.BLOCKS


class BlockDesc:
    """``BlockDesc``'s own fields; its vars and ops are the Block's."""

    __slots__ = ("idx", "parent_idx", "forward_block_idx")

    def __init__(self, idx: int, parent_idx: int = -1):
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
    """Symbolic tensor in a Block."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_parameter: bool = False,
        type: str = DENSE_TENSOR,
        need_check_feed: bool = False,
    ):
        self.block = block
        self.desc = VarDesc(
            name or unique_name.generate("_generated_var"),
            dtype=core.dtype_name(dtype), dims=shape or (), type=type,
            persistable=persistable, stop_gradient=stop_gradient,
            is_parameter=is_parameter, need_check_feed=need_check_feed)
        self.op: Optional[Operator] = None  # op that produces this var

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self) -> tuple:
        return self.desc.dims

    @shape.setter
    def shape(self, dims):
        self.desc.dims = tuple(int(d) for d in dims)

    @property
    def dtype(self) -> torch.dtype:
        return core.convert_dtype(self.desc.dtype)

    @dtype.setter
    def dtype(self, dtype):
        self.desc.dtype = core.dtype_name(dtype)

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v: bool):
        self.desc.persistable = v

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    @property
    def type(self):
        return self.desc.type

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.desc.dtype}, persistable={self.persistable})")

    __str__ = __repr__


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, name=None, trainable=True, **kw):
        kw.pop("persistable", None)
        kw.pop("is_parameter", None)
        initializer = kw.pop("initializer", None)
        self.regularizer = kw.pop("regularizer", None)
        self.need_clip = kw.pop("need_clip", True)
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         is_parameter=True, **kw)
        self.trainable = trainable
        self.initializer = initializer

    @property
    def is_parameter(self):
        return True


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


class Operator:
    """Symbolic op in a Block. Creation infers the outputs' shapes and
    dtypes through the registry."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 do_infer: bool = True):
        self.block = block
        self.desc = OpDesc(type)
        self._input_vars: Dict[str, List[Variable]] = {}
        self._output_vars: Dict[str, List[Variable]] = {}

        def _as_list(v):
            if v is None:
                return []
            return list(v) if isinstance(v, (list, tuple)) else [v]

        for slot, vars_ in sorted((inputs or {}).items()):
            vs = _as_list(vars_)
            self.desc.inputs.append((slot, [v.name for v in vs]))
            self._input_vars[slot] = vs
        for slot, vars_ in sorted((outputs or {}).items()):
            vs = _as_list(vars_)
            self.desc.outputs.append((slot, [v.name for v in vs]))
            self._output_vars[slot] = vs
            for v in vs:
                v.op = self
        for name, value in sorted((attrs or {}).items()):
            if value is not None:
                self.desc.set_attr(name, value)

        if (_flags.env_flag("PADDLE_TPU_OP_CALLSTACK")
                and type not in ("feed", "fetch")
                and "op_callstack" not in (attrs or {})):
            stack = _errs.capture_build_callstack(skip=2)
            if stack:
                self.desc.attrs["op_callstack"] = list(stack)

        from . import registry

        registry.assign_rng_id(self)
        if do_infer:
            registry.infer_op(self)

    @property
    def type(self) -> str:
        return self.desc.type

    def input_arg_names(self) -> List[str]:
        return [n for _, args in self.desc.inputs for n in args]

    def output_arg_names(self) -> List[str]:
        return [n for _, args in self.desc.outputs for n in args]

    def input(self, slot: str) -> List[str]:
        for p, args in self.desc.inputs:
            if p == slot:
                return list(args)
        return []

    def output(self, slot: str) -> List[str]:
        for p, args in self.desc.outputs:
            if p == slot:
                return list(args)
        return []

    @property
    def input_names(self) -> List[str]:
        return [p for p, _ in self.desc.inputs]

    @property
    def output_names(self) -> List[str]:
        return [p for p, _ in self.desc.outputs]

    def attr(self, name: str, default: Any = None) -> Any:
        return self.desc.attrs.get(name, default)

    def has_attr(self, name: str) -> bool:
        return name in self.desc.attrs

    def all_attrs(self) -> Dict[str, Any]:
        return dict(self.desc.attrs)

    def _set_attr(self, name: str, value: Any) -> None:
        self.desc.set_attr(name, value)

    def __repr__(self):
        ins = {p: list(a) for p, a in self.desc.inputs}
        outs = {p: list(a) for p, a in self.desc.outputs}
        return f"Op({self.type}, inputs={ins}, outputs={outs})"


# ---------------------------------------------------------------------------
# Block / Program
# ---------------------------------------------------------------------------


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.desc = BlockDesc(idx, parent_idx)
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.desc.parent_idx < 0:
            return None
        return self.program.block(self.desc.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        param = Parameter(self, **kwargs)
        # parameters live in the program's global (root) block
        gb = self.program.global_block()
        gb.vars[param.name] = param
        param.block = gb
        self.program._bump_version()
        return param

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        if _current_device_guard is not None:
            attrs = dict(attrs or {})
            attrs.setdefault("op_device", _current_device_guard)
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, vars={len(self.vars)}):"]
        lines += [f"  {op}" for op in self.ops]
        return "\n".join(lines)


class Program:
    """A program = list of blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0, -1)]
        self.current_block_idx = 0
        self._version = 0
        self._seed: Optional[int] = None
        # random op counter: gives each random op a stable id
        self._rng_op_count = 0

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = seed

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- serialization -------------------------------------------------
    def serialize_to_string(self) -> bytes:
        """``ProgramDesc`` bytes of every block's vars and ops (the JAX
        package's format; ``_proto.py``)."""
        return _proto.encode_program(
            (b.desc, [v.desc for v in b.vars.values()],
             [op.desc for op in b.ops]) for b in self.blocks)

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        """The program of ``ProgramDesc`` bytes of either package; vars are
        plain ``Variable``s (``is_parameter`` stays in their descs), as
        the JAX package parses them. Malformed bytes raise
        ``InvalidArgument``."""
        prog = Program()
        prog.blocks = []
        parsed = _proto.parse_program(data)
        for idx, parent, fwd, var_bytes, _ in parsed:
            blk = Block(prog, idx, parent)
            blk.desc.forward_block_idx = fwd
            for vb in var_bytes:
                var = Variable.__new__(Variable)
                var.block = blk
                var.desc = _proto.parse_var(
                    vb, lambda n, k, dt, dims: VarDesc(n, dt, dims, k))
                var.op = None
                blk.vars[var.name] = var
            prog.blocks.append(blk)
        for blk, (*_, op_bytes) in zip(prog.blocks, parsed):
            for ob in op_bytes:
                op = Operator.__new__(Operator)
                op.block = blk
                op.desc = _proto.parse_op(ob, OpDesc)
                op._input_vars, op._output_vars = (
                    {slot: [v for v in map(blk._find_var_recursive, args)
                            if v is not None] for slot, args in slots}
                    for slots in (op.desc.inputs, op.desc.outputs))
                for vs in op._output_vars.values():
                    for v in vs:
                        v.op = op
                blk.ops.append(op)
        if not prog.blocks:
            prog.blocks = [Block(prog, 0, -1)]
        prog._rng_op_count = sum(len(b.ops) for b in prog.blocks)
        return prog

    def clone(self, for_test: bool = False) -> "Program":
        """A copy of every block's var and op descs (no serialization).
        Parameters stay Parameters; ``for_test`` sets ``is_test`` and
        zeroes dropout, as in the JAX package."""
        p = Program()
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            nb.desc.forward_block_idx = blk.desc.forward_block_idx
            for name, var in blk.vars.items():
                nv = copy.copy(var)
                nv.block = nb
                nv.desc = var.desc.copy()
                nv.op = None
                nb.vars[name] = nv
            p.blocks.append(nb)
        for blk, nb in zip(self.blocks, p.blocks):
            for op in blk.ops:
                nop = Operator.__new__(Operator)
                nop.block = nb
                nop.desc = op.desc.copy()
                nop._input_vars = {
                    slot: [nb._find_var_recursive(v.name) for v in vs]
                    for slot, vs in op._input_vars.items()}
                nop._output_vars = {
                    slot: [nb._find_var_recursive(v.name) for v in vs]
                    for slot, vs in op._output_vars.items()}
                for vs in nop._output_vars.values():
                    for v in vs:
                        if v is not None:
                            v.op = nop
                nb.ops.append(nop)
        p.current_block_idx = 0
        p._seed = self._seed
        p._rng_op_count = self._rng_op_count
        if hasattr(self, "_extra_feeds"):
            p._extra_feeds = dict(self._extra_feeds)
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if op.has_attr("is_test"):
                        op._set_attr("is_test", True)
                    if op.type == "dropout":
                        op._set_attr("dropout_prob", 0.0)
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# ---------------------------------------------------------------------------
# default programs + guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(p: Program) -> Program:
    global _main_program_
    old, _main_program_ = _main_program_, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program_
    old, _startup_program_ = _startup_program_, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
