"""Port of ``paddle_tpu/tensor/random.py``: thin wrappers over ``ops/api.py``."""


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    from ..ops.api import dispatch

    return dispatch("uniform_random", {}, {
        "shape": [int(s) for s in shape], "dtype": str(dtype),
        "min": float(min), "max": float(max), "seed": int(seed)}, ("Out",))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    from ..ops.api import dispatch

    return dispatch("gaussian_random", {}, {
        "shape": [int(s) for s in shape or []], "mean": float(mean),
        "std": float(std), "dtype": "float32", "seed": 0}, ("Out",))


def rand(shape, dtype="float32", name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype="float32", name=None):
    return normal(0.0, 1.0, shape)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    from ..ops.api import dispatch

    if high is None:
        low, high = 0, low
    return dispatch("randint", {}, {
        "shape": [int(s) for s in shape], "low": int(low),
        "high": int(high), "dtype": str(dtype), "seed": 0}, ("Out",))


def randperm(n, dtype="int64", name=None):
    from ..ops.api import dispatch

    return dispatch("randperm", {}, {"n": int(n), "dtype": str(dtype),
                                     "seed": 0}, ("Out",))
