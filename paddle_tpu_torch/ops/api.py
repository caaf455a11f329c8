"""Dual-mode functional op API and the eager Tensor's operator overloads.

Port of ``paddle_tpu/ops/api.py``. :func:`dispatch` routes an op to the
dygraph tracer (eager mode, the default) or appends it to the current
static block; the functional API (``paddle.add``, ``paddle.matmul``,
``paddle.reshape`` ...) is built on it, and :func:`monkey_patch` gives
the eager ``Tensor`` its math operators and methods (``+``, ``@``,
``==``, ``t.sum()`` ...), each one dispatched op; the static
``Variable`` gets the same overloads and ``__getitem__``, as in the JAX
package, so ``loss * 1.0``, ``-x`` or ``a == b`` on Variables append ops.

So a ``==``, ``!=``, ``<`` ... between Variables is an op, never a
Python truth value, and a Variable has no ``__bool__`` (it is always
truthy). The port's own code therefore compares Variables by identity
or by name: never ``v in list_of_vars``, ``list.index``, ``list.remove``,
``==`` between lists of Variables, or ``sorted`` over Variables.
``__hash__`` stays the object's, so sets and dicts of Variables keep
working.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..framework import core
from ..framework import program as framework
from ..framework.layer_helper import LayerHelper


def dispatch(op_type: str, inputs: Dict[str, Any],
             attrs: Optional[Dict[str, Any]] = None,
             out_slots: Sequence[str] = ("Out",), out_dtype=None,
             out_nums: Optional[Dict[str, int]] = None):
    """Run (eager) or build (static) one op; returns one value per out
    slot (the value itself if there is one slot). A slot listed in
    ``out_nums`` with n > 1 gives a list of n values."""
    attrs = attrs or {}
    out_nums = out_nums or {}

    def pack(get):
        vals = tuple(list(get(s, out_nums[s])) if out_nums.get(s, 1) > 1
                     else get(s, 1)[0] for s in out_slots)
        return vals[0] if len(vals) == 1 else vals

    if framework.in_dygraph_mode():
        outs = framework._current_tracer().trace_op(op_type, inputs, None,
                                                    attrs)
        return pack(lambda s, n: outs[s])
    helper = LayerHelper(op_type)
    first = None
    for v in inputs.values():
        first = v[0] if isinstance(v, (list, tuple)) else v
        if first is not None:
            break
    dtype = out_dtype or (first.dtype if first is not None else "float32")
    outputs = {s: [helper.create_variable_for_type_inference(dtype)
                   for _ in range(out_nums.get(s, 1))] for s in out_slots}
    helper.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    return pack(lambda s, n: outputs[s])


# ---------------------------------------------------------------------------
# functional API built on dispatch (paddle.* tensor functions)
# ---------------------------------------------------------------------------


def _maybe_wrap(v):
    """A Python or numpy constant as a Tensor (eager) or as a
    fill_constant / assign_value output (static)."""
    from ..dygraph.varbase import Tensor

    if isinstance(v, (framework.Variable, Tensor)):
        return v
    if framework.in_dygraph_mode():
        return Tensor(np.asarray(v))
    arr = np.asarray(v)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    helper = LayerHelper("constant")
    out = helper.create_variable_for_type_inference(arr.dtype.name,
                                                    stop_gradient=True)
    if arr.ndim == 0:
        helper.append_op("fill_constant", outputs={"Out": out},
                         attrs={"shape": [], "value": float(arr),
                                "dtype": arr.dtype.name})
    else:
        key = {"float32": "fp32_values", "int32": "int32_values",
               "int64": "int64_values", "bool": "bool_values"}.get(
                   arr.dtype.name, "fp32_values")
        helper.append_op("assign_value", outputs={"Out": out},
                         attrs={"shape": list(arr.shape),
                                "dtype": arr.dtype.name,
                                key: arr.flatten().tolist()})
    return out


def _binary(op_type):
    def fn(x, y, name=None):
        return dispatch(op_type, {"X": _maybe_wrap(x), "Y": _maybe_wrap(y)},
                        {"axis": -1})

    fn.__name__ = op_type
    return fn


add = _binary("elementwise_add")
subtract = _binary("elementwise_sub")
multiply = _binary("elementwise_mul")
divide = _binary("elementwise_div")
pow_ = _binary("elementwise_pow")
mod = _binary("elementwise_mod")
floor_divide = _binary("elementwise_floordiv")
equal = _binary("equal")
not_equal = _binary("not_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")
maximum = _binary("maximum")
minimum = _binary("minimum")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")


def _unary(op_type, out_slot="Out"):
    def fn(x, name=None):
        return dispatch(op_type, {"X": x}, {}, (out_slot,))

    fn.__name__ = op_type
    return fn


_UNARY = ("relu sigmoid tanh exp log log2 log10 log1p sqrt rsqrt square abs "
          "ceil floor round reciprocal sin cos tan asin acos atan sinh cosh "
          "asinh acosh atanh erf sign softplus softsign silu logical_not "
          "isnan isinf isfinite").split()
for _n in _UNARY:
    globals()[_n] = _unary(_n)


def cast(x, dtype):
    name = core.dtype_name(dtype)
    return dispatch("cast", {"X": x}, {"out_dtype": name}, out_dtype=name)


def assign(x):
    return dispatch("assign", {"X": x})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    return dispatch("scale", {"X": x},
                    {"scale": float(scale), "bias": float(bias),
                     "bias_after_scale": bias_after_scale})


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return dispatch("matmul_v2", {"X": x, "Y": y},
                    {"trans_x": transpose_x, "trans_y": transpose_y})


def reshape(x, shape, name=None):
    return dispatch("reshape2", {"X": x}, {"shape": [int(d) for d in shape]})


def transpose(x, perm, name=None):
    return dispatch("transpose2", {"X": x}, {"axis": [int(d) for d in perm]})


def concat(x, axis=0, name=None):
    return dispatch("concat", {"X": list(x)}, {"axis": int(axis)})


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "axis": int(axis)}
        n = num_or_sections
    else:
        attrs = {"sections": list(num_or_sections), "axis": int(axis)}
        n = len(num_or_sections)
    return dispatch("split", {"X": x}, attrs, out_nums={"Out": n}) \
        if n > 1 else [dispatch("split", {"X": x}, attrs)]


def stack(x, axis=0, name=None):
    return dispatch("stack", {"X": list(x)}, {"axis": int(axis)}, ("Y",))


def unsqueeze(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else list(axis)
    return dispatch("unsqueeze2", {"X": x}, {"axes": axes})


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else (
        [axis] if isinstance(axis, int) else list(axis))
    return dispatch("squeeze2", {"X": x}, {"axes": axes})


def _reduce(op_type):
    def fn(x, axis=None, keepdim=False, name=None):
        attrs = {"keep_dim": keepdim, "reduce_all": axis is None}
        if axis is not None:
            attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
        return dispatch(op_type, {"X": x}, attrs)

    fn.__name__ = op_type
    return fn


sum = _reduce("reduce_sum")
mean = _reduce("reduce_mean")
max = _reduce("reduce_max")
min = _reduce("reduce_min")
prod = _reduce("reduce_prod")


def argmax(x, axis=-1, keepdim=False, dtype="int64", name=None):
    return dispatch("arg_max", {"X": x},
                    {"axis": axis, "keepdims": keepdim, "dtype": "int64"},
                    out_dtype="int64")


def argmin(x, axis=-1, keepdim=False, dtype="int64", name=None):
    return dispatch("arg_min", {"X": x},
                    {"axis": axis, "keepdims": keepdim, "dtype": "int64"},
                    out_dtype="int64")


def topk(x, k, axis=-1, largest=True, name=None):
    return dispatch("top_k_v2", {"X": x},
                    {"k": k, "axis": axis, "largest": largest},
                    ("Out", "Indices"))


def softmax(x, axis=-1, name=None):
    return dispatch("softmax", {"X": x}, {"axis": axis})


def clip(x, min=None, max=None, name=None):
    return dispatch("clip", {"X": x},
                    {"min": float(min) if min is not None else float("-inf"),
                     "max": float(max) if max is not None else float("inf")})


def gather(x, index, axis=0, name=None):
    return dispatch("gather", {"X": x, "Index": index}, {"axis": axis})


def where(condition, x, y, name=None):
    return dispatch("where", {"Condition": condition, "X": x, "Y": y})


def _fill(shape, value, dtype):
    name = core.dtype_name(dtype)
    return dispatch("fill_constant", {},
                    {"shape": [int(d) for d in shape], "value": float(value),
                     "dtype": name}, out_dtype=name)


def zeros(shape, dtype="float32", name=None):
    return _fill(shape, 0.0, dtype)


def ones(shape, dtype="float32", name=None):
    return _fill(shape, 1.0, dtype)


def full(shape, fill_value, dtype="float32", name=None):
    return _fill(shape, fill_value, dtype)


def _fill_like(x, value, dtype):
    return dispatch("fill_any_like", {"X": x},
                    {"value": value,
                     "dtype": -1 if dtype is None else core.dtype_name(dtype)})


def zeros_like(x, dtype=None, name=None):
    return _fill_like(x, 0.0, dtype)


def ones_like(x, dtype=None, name=None):
    return _fill_like(x, 1.0, dtype)


def arange(start=0, end=None, step=1, dtype="int64", name=None):
    if end is None:
        start, end = 0, start
    n = int(np.ceil((end - start) / step))
    return _maybe_wrap((np.arange(n) * step + start).astype(
        core.dtype_name(dtype)))


def cumsum(x, axis=None, name=None):
    return dispatch("cumsum", {"X": x},
                    {"axis": axis if axis is not None else -1,
                     "flatten": axis is None})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return dispatch("flatten_contiguous_range", {"X": x},
                    {"start_axis": start_axis, "stop_axis": stop_axis})


def bmm(x, y, name=None):
    return dispatch("bmm", {"X": x, "Y": y})


def dropout(x, p=0.5, training=True, mode="upscale_in_train", name=None):
    return dispatch("dropout", {"X": x},
                    {"dropout_prob": float(p), "is_test": not training,
                     "dropout_implementation": mode}, ("Out", "Mask"))[0]


def expand(x, shape, name=None):
    return dispatch("expand_v2", {"X": x}, {"shape": [int(d) for d in shape]})


def tile(x, repeat_times, name=None):
    return dispatch("tile", {"X": x},
                    {"repeat_times": [int(d) for d in repeat_times]})


def one_hot(x, num_classes, name=None):
    return dispatch("one_hot_v2", {"X": x}, {"depth": int(num_classes)},
                    out_dtype="float32")


def embedding_lookup(w, ids, padding_idx=-1):
    return dispatch("lookup_table_v2", {"W": w, "Ids": ids},
                    {"padding_idx": padding_idx})


def tril(x, diagonal=0, name=None):
    return dispatch("tril_triu", {"X": x},
                    {"diagonal": diagonal, "lower": True})


def triu(x, diagonal=0, name=None):
    return dispatch("tril_triu", {"X": x},
                    {"diagonal": diagonal, "lower": False})


# ---------------------------------------------------------------------------
# __getitem__
# ---------------------------------------------------------------------------


def _tensor_getitem(t, idx):
    """Integer and unit-step slice indexing through the ``slice`` op
    (differentiable); a single index array through ``gather``."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    axes, starts, ends, decrease = [], [], [], []
    advanced = None
    dim = 0
    for it in idx:
        if isinstance(it, int):
            axes.append(dim)
            starts.append(it)
            ends.append(it + 1 if it != -1 else 2 ** 31 - 1)
            decrease.append(dim)
            dim += 1
        elif isinstance(it, slice):
            if it.step not in (None, 1):
                raise NotImplementedError(
                    "strided __getitem__; use strided_slice")
            if it.start is not None or it.stop is not None:
                axes.append(dim)
                starts.append(it.start or 0)
                ends.append(it.stop if it.stop is not None else 2 ** 31 - 1)
            dim += 1
        elif it is None:
            raise NotImplementedError("newaxis in __getitem__")
        else:
            advanced = (dim, it)
            dim += 1
    if advanced is not None:
        if len(idx) != 1:
            raise NotImplementedError("mixed advanced indexing")
        return gather(t, _maybe_wrap(advanced[1]), axis=0)
    return dispatch("slice", {"Input": t},
                    {"axes": axes, "starts": starts, "ends": ends,
                     "decrease_axis": decrease})


# ---------------------------------------------------------------------------
# operator overloading (math_op_patch twin)
# ---------------------------------------------------------------------------


def _rbinary(op_type):
    def fn(self, other):
        return dispatch(op_type, {"X": _maybe_wrap(other), "Y": self},
                        {"axis": -1})

    return fn


def monkey_patch(cls):
    cls.__add__ = lambda s, o: add(s, o)
    cls.__radd__ = lambda s, o: add(s, o)
    cls.__sub__ = lambda s, o: subtract(s, o)
    cls.__rsub__ = _rbinary("elementwise_sub")
    cls.__mul__ = lambda s, o: multiply(s, o)
    cls.__rmul__ = lambda s, o: multiply(s, o)
    cls.__truediv__ = lambda s, o: divide(s, o)
    cls.__rtruediv__ = _rbinary("elementwise_div")
    cls.__pow__ = lambda s, o: pow_(s, o)
    cls.__mod__ = lambda s, o: mod(s, o)
    cls.__floordiv__ = lambda s, o: floor_divide(s, o)
    cls.__neg__ = lambda s: scale(s, -1.0)
    cls.__matmul__ = lambda s, o: matmul(s, o)
    cls.__eq__ = lambda s, o: equal(s, _maybe_wrap(o))
    cls.__ne__ = lambda s, o: not_equal(s, _maybe_wrap(o))
    cls.__lt__ = lambda s, o: less_than(s, _maybe_wrap(o))
    cls.__le__ = lambda s, o: less_equal(s, _maybe_wrap(o))
    cls.__gt__ = lambda s, o: greater_than(s, _maybe_wrap(o))
    cls.__ge__ = lambda s, o: greater_equal(s, _maybe_wrap(o))
    cls.__hash__ = object.__hash__
    # method-style API
    cls.reshape = lambda s, shape: reshape(s, shape)
    cls.transpose = lambda s, perm: transpose(s, perm)
    cls.matmul = lambda s, o, transpose_x=False, transpose_y=False: matmul(
        s, o, transpose_x, transpose_y)
    cls.sum = lambda s, axis=None, keepdim=False: sum(s, axis, keepdim)
    cls.mean = lambda s, axis=None, keepdim=False: mean(s, axis, keepdim)
    cls.max = lambda s, axis=None, keepdim=False: max(s, axis, keepdim)
    cls.min = lambda s, axis=None, keepdim=False: min(s, axis, keepdim)
    for name in ("sqrt", "exp", "log", "tanh", "sigmoid", "abs", "square"):
        setattr(cls, name, globals()[name])
    cls.flatten = lambda s, start_axis=0, stop_axis=-1: flatten(
        s, start_axis, stop_axis)
    cls.unsqueeze = lambda s, axis: unsqueeze(s, axis)
    cls.squeeze = lambda s, axis=None: squeeze(s, axis)
    cls.argmax = lambda s, axis=-1, keepdim=False: argmax(s, axis, keepdim)
    cls.scale = lambda s, scale_=1.0, bias=0.0: scale(s, scale_, bias)


def _install_patches():
    from ..dygraph.varbase import Tensor

    monkey_patch(framework.Variable)
    monkey_patch(Tensor)
    framework.Variable.__getitem__ = _tensor_getitem

