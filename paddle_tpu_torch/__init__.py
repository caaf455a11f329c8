"""paddle_tpu_torch -- the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package runs its
GPT serving path on an NVIDIA card. Its module layout mirrors
``paddle_tpu`` so each counterpart is found under the same path:

  flags.py              the PADDLE_TPU_* environment flags it reads
  framework/errors.py   typed errors
  monitor.py            metrics registry + flight recorder
  profiler.py           host spans + torch.profiler device trace
  chaos.py              deterministic fault injection
  models/gpt.py         GPTConfig
  ops/lmhead_ce.py      fused lm-head + CE forward (csrc/lmhead_ce.cu)
  serving/              continuous-batching engine over a paged KV cache
  weights.py            parameters from numpy (or the JAX package)

Importing it has no side effects: no server starts and no journal opens.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from .framework.errors import EnforceError, errors

__all__ = ["EnforceError", "errors"]
