"""Port of ``paddle_tpu/tensor/linalg.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import bmm, matmul  # noqa: F401


def dot(x, y, name=None):
    from ..ops.api import dispatch

    return dispatch("dot", {"X": x, "Y": y}, {}, ("Out",))


def norm(x, p=2, axis=None, keepdim=False, name=None):
    """Frobenius / p-norm via the composed ops (the reference
    norm builds the same reduce graph)."""
    from ..ops.api import sum as _sum
    from . import math as _m

    if p == 2:
        return _m.sqrt(_sum(_m.square(x), axis=axis, keepdim=keepdim))
    if p == 1:
        return _sum(_m.abs(x), axis=axis, keepdim=keepdim)
    powd = _m.pow(_m.abs(x), p)
    return _m.pow(_sum(powd, axis=axis, keepdim=keepdim), 1.0 / p)


def transpose(x, perm, name=None):
    from ..ops.api import transpose as _t

    return _t(x, perm, name)
