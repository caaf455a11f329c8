"""Port of ``paddle_tpu/tensor/attribute.py``: thin wrappers over ``ops/api.py``."""


def shape(x, name=None):
    from ..ops.api import dispatch

    return dispatch("shape", {"Input": x}, {}, ("Out",))


def rank(x, name=None):
    from ..ops.api import dispatch

    return dispatch("rank", {"Input": x}, {}, ("Out",))


def real(x, name=None):
    from ..ops.api import dispatch

    return dispatch("real", {"X": x}, {}, ("Out",))


def imag(x, name=None):
    from ..ops.api import dispatch

    return dispatch("imag", {"X": x}, {}, ("Out",))
