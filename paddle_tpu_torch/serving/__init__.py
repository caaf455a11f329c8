"""paddle_tpu_torch.serving -- the continuous-batching serving plane.

Port of ``paddle_tpu/serving``: an SLO-ordered admission queue, a paged
block KV cache, prefill/decode split into separate model calls, and the
serving goodput ledger, with the model running in PyTorch on a CUDA card
(or on the CPU when asked).

Layout:
  ledger.py    serving goodput buckets + SLO histograms + journal +
               reconciliations
  kv_cache.py  block allocator + paging conventions
  model.py     prefill/decode/score over gpt-named parameters
  engine.py    the continuous-batching scheduler

The JAX package's ``router.py``, ``capacity.py`` and HTTP status serving
are not ported yet.
"""
from __future__ import annotations

from . import kv_cache, ledger
from .engine import AdmissionQueue, RequestHandle, ServeRequest, ServingEngine
from .kv_cache import BlockAllocator
from .model import DecodeModel, GPTConfig, calibrate, init_params

__all__ = [
    "ledger", "kv_cache", "ServingEngine", "ServeRequest", "RequestHandle",
    "AdmissionQueue", "BlockAllocator", "DecodeModel", "GPTConfig",
    "init_params", "calibrate",
]
