"""paddle_tpu_torch.serving -- the continuous-batching serving plane.

Port of ``paddle_tpu/serving``: an SLO-ordered admission queue, a paged
block KV cache, prefill/decode split into separate model calls, the
serving goodput ledger, and the front tier that makes N replicas one
service, with the model running in PyTorch on a CUDA card (or on the CPU
when asked).

Layout:
  ledger.py    serving goodput buckets + SLO histograms + journal +
               reconciliations
  kv_cache.py  block allocator + paging conventions
  model.py     prefill/decode/score over gpt-named parameters, and the
               analytic cost record the decode roofline reads
  engine.py    the continuous-batching scheduler
  router.py    the front tier: replica failover, retry/hedging with
               backoff, draining (Local + HTTP transports)
  capacity.py  the capacity planner and autoscaler over the router's
               traffic telemetry and the decode roofline

A replica process registers its engine with :func:`set_replica_engine`;
``status.py`` then serves it on POST ``/generate`` and ``/drain``
(``tools/torch_serve_replica.py`` is such a process). Multi-device
serving recipes are not ported.
"""
from __future__ import annotations

import threading
from typing import Optional

from . import kv_cache, ledger
from .engine import AdmissionQueue, RequestHandle, ServeRequest, ServingEngine
from .kv_cache import BlockAllocator
from .model import DecodeModel, GPTConfig, calibrate, init_params
from .router import HttpReplica, LocalReplica, Router

__all__ = [
    "ledger", "kv_cache", "ServingEngine", "ServeRequest", "RequestHandle",
    "AdmissionQueue", "BlockAllocator", "DecodeModel", "GPTConfig",
    "init_params", "calibrate", "oneshot_engine", "Router", "LocalReplica",
    "HttpReplica", "set_replica_engine", "replica_engine",
]

_ONESHOT: Optional[ServingEngine] = None
_ONESHOT_LOCK = threading.Lock()

# the engine this process serves over HTTP: status.py routes POST
# /generate and /drain here (None until a replica registers one)
_REPLICA_ENGINE: Optional[ServingEngine] = None


def set_replica_engine(engine: Optional[ServingEngine]) -> None:
    """Register THE engine this process serves over the status server's
    /generate + /drain endpoints (one replica process, one engine)."""
    global _REPLICA_ENGINE
    _REPLICA_ENGINE = engine


def replica_engine() -> Optional[ServingEngine]:
    return _REPLICA_ENGINE


def oneshot_engine() -> ServingEngine:
    """The process-wide execute-only engine (batch-of-one client): every
    ``execute`` thunk is admitted, queued, timed and retired on the
    serving lifecycle. Model-less (no KV cache, no decode, no device);
    created on first use so unused imports stay inert. Slots here are
    concurrency tickets: thunks run on their submitters' threads, up to
    max_batch in flight."""
    global _ONESHOT
    with _ONESHOT_LOCK:
        if _ONESHOT is None:
            _ONESHOT = ServingEngine(model=None)
        return _ONESHOT
