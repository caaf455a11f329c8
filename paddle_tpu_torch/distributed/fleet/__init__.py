"""Fleet (mirrors ``paddle_tpu/distributed/fleet``): only
``RecomputeOptimizer`` is ported. Any other public fleet name raises
``errors.Unimplemented`` naming ROADMAP A10, where the rest of fleet
(the other meta-optimizers, role makers, the distributed strategy, the
metrics) waits for the multi-device slice."""
from __future__ import annotations

from ...framework import errors as _errs
from .meta_optimizers import RecomputeOptimizer

__all__ = ["RecomputeOptimizer"]


def __getattr__(name: str):
    if name.startswith("_"):
        raise AttributeError(name)
    raise _errs.errors.Unimplemented(
        f"paddle_tpu_torch.distributed.fleet.{name} is not ported: the "
        f"port's fleet has RecomputeOptimizer only; the rest of fleet "
        f"comes with the multi-device slice (ROADMAP.md queue A, item A10)")
