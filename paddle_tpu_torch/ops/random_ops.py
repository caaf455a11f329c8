"""Random op lowerings: the initializers' draws.

Port of the ``gaussian_random``, ``uniform_random`` and
``truncated_gaussian_random`` rules of ``paddle_tpu/ops/random_ops.py``.
Each draw comes from a ``torch.Generator`` seeded from the op's ``seed``
attr when it is set, else from (program seed, step, the op's
``_rng_id``) through the lowering context. The numbers differ from the
JAX package's threefry draws for the same seed; the distributions are
the same.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import maybe, torch_dtype


def _shape_attr(ins, attrs):
    shape = maybe(ins, "ShapeTensor", attrs.get("shape", []))
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return tuple(int(d) for d in shape)


def _generator(ctx, attrs):
    return ctx.generator(attrs.get("_rng_id", 0), seed=attrs.get("seed", 0))


@register_op("gaussian_random", stop_gradient=True, uses_rng=True)
def _gaussian_random(ctx, ins, attrs):
    out = torch.randn(_shape_attr(ins, attrs), generator=_generator(ctx, attrs),
                      dtype=torch.float32, device=ctx.device)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}


@register_op("uniform_random", stop_gradient=True, uses_rng=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(_shape_attr(ins, attrs), generator=_generator(ctx, attrs),
                     dtype=torch.float32, device=ctx.device)
    out = lo + (hi - lo) * out
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", stop_gradient=True, uses_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    out = torch.empty(_shape_attr(ins, attrs), dtype=torch.float32,
                      device=ctx.device)
    if ctx.device.type != "meta":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=_generator(ctx, attrs))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "float32")))}
