"""Port of ``paddle_tpu/tensor/manipulation.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import (  # noqa: F401
    cast, concat, expand, flatten, gather, reshape, split, squeeze, stack,
    tile, transpose, unsqueeze,
)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def roll(x, shifts, axis=None, name=None):
    from ..ops.api import dispatch

    sh = shifts if isinstance(shifts, (list, tuple)) else [shifts]
    ax = axis if axis is None or isinstance(axis, (list, tuple)) else [axis]
    return dispatch("roll", {"X": x},
                    {"shifts": [int(s) for s in sh],
                     "axis": [] if ax is None else [int(a) for a in ax]},
                    ("Out",))


def flip(x, axis, name=None):
    from ..ops.api import dispatch

    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return dispatch("flip", {"X": x}, {"axis": [int(a) for a in ax]}, ("Out",))


def gather_nd(x, index, name=None):
    from ..ops.api import dispatch

    return dispatch("gather_nd", {"X": x, "Index": index}, {}, ("Out",))


def scatter(x, index, updates, overwrite=True, name=None):
    from ..ops.api import dispatch

    return dispatch("scatter", {"X": x, "Ids": index, "Updates": updates},
                    {"overwrite": bool(overwrite)}, ("Out",))
