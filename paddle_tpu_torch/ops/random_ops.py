"""Random op lowerings: the initializers' draws.

Port of the ``gaussian_random``, ``uniform_random`` and
``truncated_gaussian_random`` rules of ``paddle_tpu/ops/random_ops.py``.
Each draw is the lowering context's counter-based draw
(``LoweringContext.uniform``): from the op's ``seed`` attr when it is set,
else from the run's (program seed, step) tensor on the device and the
op's ``_rng_id``, so a captured step draws anew at every replay. Uniform
numbers carry 24 random bits; the normal draws invert the normal CDF
(``erfinv``) at those numbers shifted half a step off 0, the truncated
one inside [-2, 2] standard deviations. The numbers differ from the JAX
package's threefry draws for the same seed; the distributions are the
same.
"""
from __future__ import annotations

import math

import torch

from ..framework.registry import register_op
from .common import maybe, torch_dtype


def _shape_attr(ins, attrs):
    shape = maybe(ins, "ShapeTensor", attrs.get("shape", []))
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return tuple(int(d) for d in shape)


def _uniform(ctx, ins, attrs) -> torch.Tensor:
    return ctx.uniform(attrs.get("_rng_id", 0), _shape_attr(ins, attrs),
                       seed=attrs.get("seed", 0))


def _normal_at(u: torch.Tensor, lo: float = 0.0, hi: float = 1.0
               ) -> torch.Tensor:
    """Standard normal numbers at the CDF values ``lo + (hi - lo) * u'``
    (u' = u shifted half a step of 2^-24 off 0), in float64 for the tails,
    returned in fp32."""
    p = lo + (hi - lo) * (u.double() + 2.0 ** -25)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).float()


def _phi(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


@register_op("gaussian_random", stop_gradient=True, uses_rng=True)
def _gaussian_random(ctx, ins, attrs):
    out = _normal_at(_uniform(ctx, ins, attrs))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}


@register_op("uniform_random", stop_gradient=True, uses_rng=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = lo + (hi - lo) * _uniform(ctx, ins, attrs)
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", stop_gradient=True, uses_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    out = _normal_at(_uniform(ctx, ins, attrs), _phi(-2.0), _phi(2.0))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}
