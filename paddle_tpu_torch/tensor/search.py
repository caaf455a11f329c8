"""Port of ``paddle_tpu/tensor/search.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import argmax, argmin, topk, where  # noqa: F401


def sort(x, axis=-1, descending=False, name=None):
    from ..ops.api import dispatch

    return dispatch("argsort", {"X": x},
                    {"axis": int(axis), "descending": bool(descending)},
                    ("Out",))


def argsort(x, axis=-1, descending=False, name=None):
    from ..ops.api import dispatch

    return dispatch("argsort", {"X": x},
                    {"axis": int(axis), "descending": bool(descending)},
                    ("Out", "Indices"))[1]


def index_select(x, index, axis=0, name=None):
    from ..ops.api import gather

    return gather(x, index, axis=axis)


def masked_select(x, mask, name=None):
    from ..ops.api import dispatch

    return dispatch("masked_select", {"X": x, "Mask": mask}, {}, ("Y",))


def nonzero(x, as_tuple=False, name=None):
    from ..ops.api import dispatch

    out = dispatch("where_index", {"Condition": x}, {}, ("Out",))
    if not as_tuple:
        return out
    n = len(out.shape) if hasattr(out, "shape") else 1
    from ..ops.api import split as _split

    return tuple(_split(out, out.shape[-1], axis=-1))
