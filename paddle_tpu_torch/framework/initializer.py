"""Parameter initializers.

Port of ``paddle_tpu/framework/initializer.py``: each initializer appends
an init op for the parameter to the *startup program*, which the executor
runs once to fill the scope. The ops and their attrs are the JAX
package's; the random ops draw from the port's counter-based hash of
the seed and step (``registry.draw_bits``), so the two packages give
different numbers from one seed (tests hand both the same
numpy values instead, ``weights.scope_from_numpy``).
"""
from __future__ import annotations

import math

import numpy as np

from . import core
from . import program as framework


def _startup_block(param):
    startup = framework.default_startup_program()
    block = startup.global_block()
    if param.name not in block.vars:
        block.create_var(
            name=param.name,
            shape=param.shape,
            dtype=param.dtype,
            persistable=True,
            stop_gradient=True,
        )
    return block


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, param, block=None):
        block = block or _startup_block(param)
        return block.append_op(
            "fill_constant",
            outputs={"Out": block.vars[param.name]},
            attrs={
                "shape": list(param.shape),
                "value": float(self.value),
                "dtype": core.dtype_name(param.dtype),
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, param, block=None):
        block = block or _startup_block(param)
        return block.append_op(
            "uniform_random",
            outputs={"Out": block.vars[param.name]},
            attrs={
                "shape": list(param.shape),
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
                "dtype": core.dtype_name(param.dtype),
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block=None):
        block = block or _startup_block(param)
        return block.append_op(
            "gaussian_random",
            outputs={"Out": block.vars[param.name]},
            attrs={
                "shape": list(param.shape),
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
                "dtype": core.dtype_name(param.dtype),
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block=None):
        block = block or _startup_block(param)
        return block.append_op(
            "truncated_gaussian_random",
            outputs={"Out": block.vars[param.name]},
            attrs={
                "shape": list(param.shape),
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
                "dtype": core.dtype_name(param.dtype),
            },
        )


def _fans(param):
    shape = param.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, param, block=None):
        fi, fo = _fans(param)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(param, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(param, block)


class MSRAInitializer(Initializer):
    """Kaiming init (reference initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0, negative_slope=0.0, nonlinearity="relu"):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, param, block=None):
        fi, _ = _fans(param)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(param, block)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed)(param, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, param, block=None):
        block = block or _startup_block(param)
        arr = self.value
        key = {
            "float32": "fp32_values",
            "float64": "fp64_values",
            "int32": "int32_values",
            "int64": "int64_values",
            "bool": "bool_values",
        }.get(arr.dtype.name, "fp32_values")
        return block.append_op(
            "assign_value",
            outputs={"Out": block.vars[param.name]},
            attrs={
                "shape": list(arr.shape),
                "dtype": core.dtype_name(param.dtype),
                key: arr.flatten().tolist(),
            },
        )


# 2.0-style aliases (python/paddle/nn/initializer/)
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
XavierUniform = lambda **kw: XavierInitializer(uniform=True, **kw)
XavierNormal = lambda **kw: XavierInitializer(uniform=False, **kw)
KaimingUniform = lambda **kw: MSRAInitializer(uniform=True, **kw)
KaimingNormal = lambda **kw: MSRAInitializer(uniform=False, **kw)
Assign = NumpyArrayInitializer

_global_weight_initializer = None
_global_bias_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_initializer, _global_bias_initializer
    _global_weight_initializer = weight_init
    _global_bias_initializer = bias_init


def global_weight_initializer():
    return _global_weight_initializer


def global_bias_initializer():
    return _global_bias_initializer
