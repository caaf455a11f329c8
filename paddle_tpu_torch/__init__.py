"""paddle_tpu_torch -- the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package runs its
GPT serving and training paths on an NVIDIA card. Its module layout mirrors
``paddle_tpu`` so each counterpart is found under the same path:

  flags.py              the PADDLE_TPU_* environment flags it reads
  framework/errors.py   typed errors
  monitor.py            metrics registry + flight recorder
  profiler.py           host spans + torch.profiler device trace
  chaos.py              deterministic fault injection
  framework/            program IR, autodiff (recompute too), executor
  models/gpt.py         GPTConfig and the training program
  optimizer/            the optimizers; nn/clip.py, regularizer.py
  distributed/fleet/    RecomputeOptimizer
  ops/                  op lowerings and the CUDA kernels' wrappers
  serving/              continuous-batching engine over a paged KV cache
  weights.py            parameters from numpy (or the JAX package)

Importing it has no side effects: no server starts and no journal opens.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or ``set_device("cpu")``, which names the default place).
"""
from __future__ import annotations

from .framework.core import get_device, set_device
from .framework.errors import EnforceError, errors

__all__ = ["EnforceError", "errors", "get_device", "set_device"]
