"""Port of ``paddle_tpu/tensor/logic.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import (  # noqa: F401
    equal, greater_equal, greater_than, less_equal, less_than,
    logical_and, logical_or, logical_xor, not_equal,
)


def logical_not(x, name=None):
    from ..ops.api import dispatch

    return dispatch("logical_not", {"X": x}, {}, ("Out",))


def is_empty(x, name=None):
    from ..ops.api import dispatch

    return dispatch("is_empty", {"X": x}, {}, ("Out",))


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    from ..ops.api import dispatch

    return dispatch("allclose", {"Input": x, "Other": y},
                    {"rtol": float(rtol), "atol": float(atol),
                     "equal_nan": bool(equal_nan)}, ("Out",))
