"""Port of ``paddle_tpu/tensor/creation.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import (  # noqa: F401
    arange, full, ones, ones_like, zeros, zeros_like,
)


def full_like(x, fill_value, dtype=None, name=None):
    from ..ops.api import dispatch

    attrs = {"value": float(fill_value)}
    if dtype is not None:
        attrs["dtype"] = str(dtype)
    return dispatch("fill_any_like", {"X": x}, attrs, ("Out",))


def linspace(start, stop, num, dtype="float32", name=None):
    from ..ops.api import dispatch

    return dispatch("linspace", {}, {
        "start": float(start), "stop": float(stop), "num": int(num),
        "dtype": str(dtype)}, ("Out",))


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    from ..ops.api import dispatch

    return dispatch("eye", {}, {
        "num_rows": int(num_rows),
        "num_columns": int(num_columns or num_rows),
        "dtype": str(dtype)}, ("Out",))
