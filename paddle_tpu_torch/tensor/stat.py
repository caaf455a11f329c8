"""Port of ``paddle_tpu/tensor/stat.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import mean  # noqa: F401


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    from ..ops.api import dispatch

    # composed of mean, subtract and square, as in the reference
    from ..ops.api import mean as _mean
    from ..ops.api import multiply, subtract

    m = _mean(x, axis=axis, keepdim=True)
    d = subtract(x, m)
    v = _mean(multiply(d, d), axis=axis, keepdim=keepdim)
    if unbiased:
        import numpy as np

        shape = x.shape
        if axis is None:
            n = int(np.prod(shape))
        else:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            n = int(np.prod([shape[a] for a in axes]))
        if n > 1:
            from ..ops.api import scale as _scale

            v = _scale(v, scale=n / (n - 1))
    return v


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    from . import math as _m

    return _m.sqrt(var(x, axis, unbiased, keepdim))


def median(x, axis=None, keepdim=False, name=None):
    from ..ops.api import dispatch

    attrs = {"keep_dim": bool(keepdim)}
    if axis is not None:
        attrs["axis"] = int(axis)
    return dispatch("median", {"X": x}, attrs, ("Out",))


def numel(x, name=None):
    from ..ops.api import dispatch

    return dispatch("size", {"Input": x}, {}, ("Out",))
