"""Port of ``paddle_tpu/tensor/math.py``: thin wrappers over ``ops/api.py``."""
from ..ops.api import (  # noqa: F401
    add, subtract, multiply, divide, mod, floor_divide, maximum, minimum,
    scale, clip, cumsum, sum, mean, max, min, prod,
)
from ..ops.api import pow_ as pow  # noqa: F401
from ..ops.api import _unary as __unary

abs = __unary("abs")
exp = __unary("exp")
log = __unary("log")
sqrt = __unary("sqrt")
rsqrt = __unary("rsqrt")
square = __unary("square")
sin = __unary("sin")
cos = __unary("cos")
tanh = __unary("tanh")
floor = __unary("floor")
ceil = __unary("ceil")
round = __unary("round")
sign = __unary("sign")
reciprocal = __unary("reciprocal")
