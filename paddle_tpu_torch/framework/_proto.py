"""The ``framework.proto`` wire format, written and read without protobuf.

The JAX package serializes a program with the generated protobuf classes
of ``paddle_tpu/proto/framework.proto`` (``framework_pb2``); the port's
descs are plain Python (``program.py``) and the machines it runs on may
have no protobuf package, so this module writes and reads the same bytes
itself: varints, fixed 32/64-bit values and length-delimited fields, with
the schema's field numbers and enums copied below. A program saved by
either package parses in the other.

- **Writing** follows the field order of the schema (what protobuf's
  own serializer emits), repeated scalars unpacked as proto2 declares
  them; an optional field is written when set, a default-valued
  ``forward_block_idx`` (-1) not at all.
- **Reading** accepts packed and unpacked repeated scalars, skips
  unknown fields, and raises ``errors.InvalidArgument`` on malformed
  bytes: a truncated varint or field, a length past the end, an unknown
  wire type, bad UTF-8, a wrong wire type for a known field, or a
  missing required field.
- **Attribute types** follow the JAX package's ``_set_attr``
  (``paddle_tpu/framework/program.py``): bool -> BOOLEAN, int -> INT or
  LONG by range, float -> FLOAT64, str -> STRING, a Block -> BLOCK, a
  list by its first element (an empty list -> INTS). A parsed attribute
  whose type the value alone would not give back (BLOCK, a LONG in int32
  range, a FLOAT, an empty FLOATS) keeps its type in
  ``OpDesc.attr_types``, so a round trip returns the same type.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

from . import errors as _errs

# -- enums of framework.proto -------------------------------------------------

# AttrType
INT, FLOAT, STRING, INTS, FLOATS, STRINGS = 0, 1, 2, 3, 4, 5
BOOLEAN, BOOLEANS, BLOCK, LONG, BLOCKS, LONGS, FLOAT64 = 6, 7, 8, 9, 10, 11, 12
ATTR_TYPES = frozenset(range(13))

# VarType.Type: element types, by the port's dtype names
DTYPE_TO_ENUM = {
    "bool": 0, "int16": 1, "int32": 2, "int64": 3, "float16": 4,
    "float32": 5, "float64": 6, "uint8": 20, "int8": 21, "bfloat16": 22,
    "complex64": 23, "complex128": 24, "uint16": 25, "uint32": 26,
    "uint64": 27, "float8_e4m3fn": 32, "float8_e5m2": 33,
}
ENUM_TO_DTYPE = {v: k for k, v in DTYPE_TO_ENUM.items()}

# VarType.Type: variable kinds, by the port's type names
KIND_TO_ENUM = {
    "dense_tensor": 7, "selected_rows": 8, "feed_minibatch": 9,
    "fetch_list": 10, "step_scopes": 11, "tensor_array": 13,
    "place_list": 14, "reader": 15, "raw": 17, "tuple": 18, "string": 29,
}
ENUM_TO_KIND = {v: k for k, v in KIND_TO_ENUM.items()}
_TENSOR_KINDS = {"dense_tensor": 2, "selected_rows": 3}  # -> VarType field

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

_INT32 = (-(2 ** 31), 2 ** 31)


def _bad(what: str) -> _errs.InvalidArgumentError:
    return _errs.errors.InvalidArgument(f"malformed ProgramDesc bytes: {what}")


# -- writing --------------------------------------------------------------------


def _varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # negative ints: ten bytes of two's complement
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _tag(out: bytearray, field: int, wire: int) -> None:
    _varint(out, (field << 3) | wire)


def _w_int(out, field, v) -> None:
    _tag(out, field, _VARINT)
    _varint(out, int(v))


def _w_bytes(out, field, b: bytes) -> None:
    _tag(out, field, _LEN)
    _varint(out, len(b))
    out += b


def _w_str(out, field, s: str) -> None:
    _w_bytes(out, field, s.encode("utf-8"))


def _w_float(out, field, v) -> None:
    _tag(out, field, _I32)
    out += struct.pack("<f", float(v))


def _w_double(out, field, v) -> None:
    _tag(out, field, _I64)
    out += struct.pack("<d", float(v))


def attr_type(value: Any) -> int:
    """The AttrType the JAX package's ``_set_attr`` gives ``value`` (a
    Block already stored as its index types as INT: its BLOCK type rides
    in ``OpDesc.attr_types``)."""
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, int):
        return INT if _INT32[0] <= value < _INT32[1] else LONG
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    if isinstance(value, (list, tuple)):
        if not value:
            return INTS
        first = value[0]
        if isinstance(first, bool):
            return BOOLEANS
        if isinstance(first, int):
            return (INTS if all(_INT32[0] <= v < _INT32[1] for v in value)
                    else LONGS)
        if isinstance(first, float):
            return FLOATS
        if isinstance(first, str):
            return STRINGS
    raise _errs.errors.InvalidArgument(f"unsupported attr value: {value!r}")


def _attr_fits(t: int, value: Any) -> bool:
    """Whether a kept type ``t`` can still carry ``value``."""
    if t == FLOAT:
        return isinstance(value, float)
    if t in (BLOCK, LONG):
        return attr_type(value) in ((INT,) if t == BLOCK else (INT, LONG))
    if not isinstance(value, (list, tuple)):
        return False
    if not value:
        return True
    return attr_type(value) in {BLOCKS: (INTS,), LONGS: (INTS, LONGS)}.get(
        t, (t,))


def _attr(name: str, value: Any, kept: Optional[int]) -> bytes:
    t = kept if kept is not None and _attr_fits(kept, value) \
        else attr_type(value)
    out = bytearray()
    _w_str(out, 1, name)
    _w_int(out, 2, t)
    if t == INT:
        _w_int(out, 3, value)
    elif t == FLOAT:
        _w_float(out, 4, value)
    elif t == STRING:
        _w_str(out, 5, value)
    elif t == INTS:
        for v in value:
            _w_int(out, 6, v)
    elif t == FLOATS:
        for v in value:
            _w_float(out, 7, v)
    elif t == STRINGS:
        for v in value:
            _w_str(out, 8, v)
    elif t == BOOLEAN:
        _w_int(out, 10, bool(value))
    elif t == BOOLEANS:
        for v in value:
            _w_int(out, 11, bool(v))
    elif t == BLOCK:
        _w_int(out, 12, value)
    elif t == LONG:
        _w_int(out, 13, value)
    elif t == BLOCKS:
        for v in value:
            _w_int(out, 14, v)
    elif t == LONGS:
        for v in value:
            _w_int(out, 15, v)
    else:  # FLOAT64
        _w_double(out, 16, value)
    return bytes(out)


def _op(desc) -> bytes:
    out = bytearray()
    for field, slots in ((1, desc.inputs), (2, desc.outputs)):
        for param, args in slots:
            var = bytearray()
            _w_str(var, 1, param)
            for a in args:
                _w_str(var, 2, a)
            _w_bytes(out, field, bytes(var))
    _w_str(out, 3, desc.type)
    for name, value in desc.attrs.items():
        _w_bytes(out, 4, _attr(name, value, desc.attr_types.get(name)))
    return bytes(out)


def _var(desc) -> bytes:
    vtype = bytearray()
    if desc.type not in KIND_TO_ENUM:
        raise _errs.errors.InvalidArgument(
            f"variable {desc.name!r} has an unknown type {desc.type!r}")
    _w_int(vtype, 1, KIND_TO_ENUM[desc.type])
    field = _TENSOR_KINDS.get(desc.type)
    if field is not None:
        tensor = bytearray()
        if desc.dtype not in DTYPE_TO_ENUM:
            raise _errs.errors.InvalidArgument(
                f"variable {desc.name!r} has an unknown dtype {desc.dtype!r}")
        _w_int(tensor, 1, DTYPE_TO_ENUM[desc.dtype])
        for d in desc.dims:
            _w_int(tensor, 2, d)
        _w_bytes(vtype, field, bytes(tensor))
    out = bytearray()
    _w_str(out, 1, desc.name)
    _w_bytes(out, 2, bytes(vtype))
    for field, flag in ((3, desc.persistable), (4, desc.need_check_feed),
                        (5, desc.is_parameter), (6, desc.stop_gradient)):
        _w_int(out, field, bool(flag))
    for axis in desc.dims_mapping:
        _w_str(out, 7, axis)
    return bytes(out)


def encode_program(blocks) -> bytes:
    """``ProgramDesc`` bytes of ``blocks``: (BlockDesc, [VarDesc],
    [OpDesc]) triples in block order."""
    out = bytearray()
    for bdesc, vars_, ops in blocks:
        blk = bytearray()
        _w_int(blk, 1, bdesc.idx)
        _w_int(blk, 2, bdesc.parent_idx)
        for v in vars_:
            _w_bytes(blk, 3, _var(v))
        for op in ops:
            _w_bytes(blk, 4, _op(op))
        if bdesc.forward_block_idx != -1:
            _w_int(blk, 5, bdesc.forward_block_idx)
        _w_bytes(out, 1, bytes(blk))
    return bytes(out)


# -- reading --------------------------------------------------------------------


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while True:
        if pos >= len(data):
            raise _bad("truncated varint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise _bad("varint longer than ten bytes")


def _fields(data: bytes) -> List[Tuple[int, int, Any]]:
    """(field number, wire type, value) of every field in ``data``: an int
    for varints, raw bytes for the others."""
    out, pos, n = [], 0, len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 0:
            raise _bad("field number 0")
        if wire == _VARINT:
            val, pos = _read_varint(data, pos)
        elif wire in (_I64, _I32):
            size = 8 if wire == _I64 else 4
            if pos + size > n:
                raise _bad("truncated fixed-width field")
            val, pos = data[pos:pos + size], pos + size
        elif wire == _LEN:
            size, pos = _read_varint(data, pos)
            if pos + size > n:
                raise _bad("length-delimited field runs past the end")
            val, pos = data[pos:pos + size], pos + size
        else:
            raise _bad(f"wire type {wire}")
        out.append((field, wire, val))
    return out


def _signed(v: int, bits: int) -> int:
    v &= (1 << 64) - 1
    if v >= 1 << 63:
        v -= 1 << 64
    if bits == 32:  # an int32 keeps its low 32 bits
        v = (v + 2 ** 31) % 2 ** 32 - 2 ** 31
    return v


def _str(wire, val) -> str:
    if wire != _LEN:
        raise _bad("a string field with a non-length wire type")
    try:
        return val.decode("utf-8")
    except UnicodeDecodeError as e:
        raise _bad(f"invalid UTF-8 ({e})") from None


def _msg(wire, val) -> bytes:
    if wire != _LEN:
        raise _bad("a message field with a non-length wire type")
    return val


def _ints(wire, val, bits) -> List[int]:
    """One varint field's values: a single varint, or a packed run."""
    if wire == _VARINT:
        return [_signed(val, bits)]
    if wire != _LEN:
        raise _bad("an integer field with a fixed wire type")
    vals, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        vals.append(_signed(v, bits))
    return vals


def _int(wire, val, bits=32) -> int:
    if wire != _VARINT:
        raise _bad("a scalar integer field with a non-varint wire type")
    return _signed(val, bits)


def _fixed(wire, val, want, fmt) -> List[float]:
    size = struct.calcsize(fmt)
    if wire == want:
        return [struct.unpack(fmt, val)[0]]
    if wire != _LEN or len(val) % size:
        raise _bad("a floating-point field with the wrong wire type")
    return [struct.unpack_from(fmt, val, i)[0]
            for i in range(0, len(val), size)]


def _require(found: set, need: tuple, what: str) -> None:
    missing = [n for n in need if n not in found]
    if missing:
        raise _bad(f"{what} lacks required field(s) {missing}")


def _parse_attr(data: bytes) -> Tuple[str, int, Any]:
    name, t = None, None
    vals: Dict[int, List[Any]] = {}
    for field, wire, val in _fields(data):
        if field == 1:
            name = _str(wire, val)
        elif field == 2:
            t = _int(wire, val)
        elif field in (3, 12, 6, 14):
            vals.setdefault(field, []).extend(_ints(wire, val, 32))
        elif field in (13, 15):
            vals.setdefault(field, []).extend(_ints(wire, val, 64))
        elif field in (10, 11):
            vals.setdefault(field, []).extend(
                bool(v) for v in _ints(wire, val, 64))
        elif field in (4, 7):
            vals.setdefault(field, []).extend(_fixed(wire, val, _I32, "<f"))
        elif field == 16:
            vals.setdefault(field, []).extend(_fixed(wire, val, _I64, "<d"))
        elif field in (5, 8):
            vals.setdefault(field, []).append(_str(wire, val))
    if name is None or t is None:
        raise _bad("an OpDesc.Attr lacks its name or type")
    if t not in ATTR_TYPES:
        raise _bad(f"attribute {name!r} has unknown type {t}")
    scalar = {INT: 3, FLOAT: 4, STRING: 5, BOOLEAN: 10, BLOCK: 12,
              LONG: 13, FLOAT64: 16}
    lists = {INTS: 6, FLOATS: 7, STRINGS: 8, BOOLEANS: 11, BLOCKS: 14,
             LONGS: 15}
    if t in scalar:
        got = vals.get(scalar[t])
        # an unset optional reads as its default, as protobuf's does
        default = {STRING: "", BOOLEAN: False, FLOAT: 0.0,
                   FLOAT64: 0.0}.get(t, 0)
        value = got[-1] if got else default
    else:
        value = list(vals.get(lists[t], []))
    return name, t, value


def _parse_slots(data: bytes) -> Tuple[str, List[str]]:
    param, args = None, []
    for field, wire, val in _fields(data):
        if field == 1:
            param = _str(wire, val)
        elif field == 2:
            args.append(_str(wire, val))
    if param is None:
        raise _bad("an OpDesc.Var lacks its parameter")
    return param, args


def parse_op(data: bytes, make_op):
    """An OpDesc from ``make_op(type)``, its slots, attrs and kept attr
    types filled from ``data``."""
    op_type, inputs, outputs, attrs = None, [], [], []
    for field, wire, val in _fields(data):
        if field == 1:
            inputs.append(_parse_slots(_msg(wire, val)))
        elif field == 2:
            outputs.append(_parse_slots(_msg(wire, val)))
        elif field == 3:
            op_type = _str(wire, val)
        elif field == 4:
            attrs.append(_parse_attr(_msg(wire, val)))
    if op_type is None:
        raise _bad("an OpDesc lacks its type")
    desc = make_op(op_type)
    desc.inputs, desc.outputs = inputs, outputs
    for name, t, value in attrs:
        desc.attrs[name] = value
        if t != attr_type(value):
            desc.attr_types[name] = t
    return desc


def _parse_tensor(data: bytes) -> Tuple[str, Tuple[int, ...]]:
    dtype, dims = None, []
    for field, wire, val in _fields(data):
        if field == 1:
            dtype = _int(wire, val)
        elif field == 2:
            dims.extend(_ints(wire, val, 64))
    if dtype is None:
        raise _bad("a TensorDesc lacks its data_type")
    if dtype not in ENUM_TO_DTYPE:
        raise _bad(f"unknown data_type {dtype}")
    return ENUM_TO_DTYPE[dtype], tuple(dims)


def parse_var(data: bytes, make_var):
    """A VarDesc from ``make_var(name, kind, dtype, dims)``, flags filled
    from ``data``."""
    name, kind, tensor = None, None, None
    flags: Dict[int, bool] = {}
    dims_mapping: List[str] = []
    for field, wire, val in _fields(data):
        if field == 1:
            name = _str(wire, val)
        elif field == 2:
            for f2, w2, v2 in _fields(_msg(wire, val)):
                if f2 == 1:
                    kind = _int(w2, v2)
                elif f2 in (2, 3):
                    tensor = (f2, _parse_tensor(_msg(w2, v2)))
        elif field in (3, 4, 5, 6):
            flags[field] = bool(_int(wire, val, 64))
        elif field == 7:
            dims_mapping.append(_str(wire, val))
    if name is None or kind is None:
        raise _bad("a VarDesc lacks its name or type")
    if kind not in ENUM_TO_KIND:
        raise _bad(f"variable {name!r} has unknown type {kind}")
    kind_name = ENUM_TO_KIND[kind]
    dtype, dims = "float32", ()
    if tensor is not None and tensor[0] == _TENSOR_KINDS.get(kind_name):
        dtype, dims = tensor[1]
    desc = make_var(name, kind_name, dtype, dims)
    desc.persistable = flags.get(3, False)
    desc.need_check_feed = flags.get(4, False)
    desc.is_parameter = flags.get(5, False)
    desc.stop_gradient = flags.get(6, False)
    desc.dims_mapping = tuple(dims_mapping)
    return desc


def parse_program(data: bytes) -> List[Tuple[int, int, int, list, list]]:
    """(idx, parent_idx, forward_block_idx, [VarDesc bytes],
    [OpDesc bytes]) of each block of ``data``, in order."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise _errs.errors.InvalidArgument(
            f"ProgramDesc bytes expected, got {type(data).__name__}")
    data = bytes(data)
    blocks = []
    for field, wire, val in _fields(data):
        if field != 1:
            if field == 2:
                _fields(_msg(wire, val))  # Version: checked, not kept
            continue
        idx = parent = None
        fwd = -1
        vars_, ops = [], []
        for f2, w2, v2 in _fields(_msg(wire, val)):
            if f2 == 1:
                idx = _int(w2, v2)
            elif f2 == 2:
                parent = _int(w2, v2)
            elif f2 == 3:
                vars_.append(_msg(w2, v2))
            elif f2 == 4:
                ops.append(_msg(w2, v2))
            elif f2 == 5:
                fwd = _int(w2, v2)
        if idx is None or parent is None:
            raise _bad("a BlockDesc lacks its idx or parent_idx")
        blocks.append((idx, parent, fwd, vars_, ops))
    return blocks
