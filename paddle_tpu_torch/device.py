"""Device enumeration and the one place device memory is read.

Port of ``paddle_tpu/device.py``'s counting and memory half (its
``set_device``/``get_device`` are ``framework/core.py``'s, as in the JAX
package). :func:`memory_stats`
normalizes the CUDA caching allocator's statistics
(``torch.cuda.memory_stats``) into the JAX package's fixed schema, so
``memwatch.py`` reads the card as the reference reads a TPU's PJRT
allocator:

  allocated_bytes.all.current  -> bytes_in_use
  allocated_bytes.all.peak     -> peak_bytes_in_use
  the card's total memory      -> bytes_limit
  allocation.all.allocated     -> num_allocs

Every numeric key of the allocator rides along under ``raw``. On the CPU
there is no allocator to ask: ``source`` is ``"synthetic"``, as in the
JAX package, and ``bytes_in_use`` is the bytes of the CPU tensors that
the live scopes hold (``framework.scope.live_scopes``: the programs'
parameters, optimizer state and other persistables; each storage counted
once, however many views share it), with a running peak kept here so the
watermark behaves as an allocator's does. A run's intermediates are not
in it. That is the reference's own CPU route (it sums
``jax.live_arrays()``; a scan of every live tensor costs tens of ms a
sample here), not a fallback for the card.
"""
from __future__ import annotations

import torch

from .framework.core import get_device, set_device  # noqa: F401

__all__ = ["device_count", "get_device", "get_device_properties",
           "memory_stats", "reset_peak_memory_stats", "set_device",
           "synchronize"]

# the normalized name <- the CUDA caching allocator's key
_CUDA_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
    ("num_allocs", "allocation.all.allocated"),
)

# the synthetic source's running peak, by device
_synth_peak: dict = {}


def _resolve(device=None) -> torch.device:
    """``device`` as a torch device; none means the current CUDA card, or
    the CPU where there is no card (the JAX package likewise reads its
    default backend, which is the CPU where there is no accelerator)."""
    if device is None:
        if torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    if isinstance(device, int):
        return torch.device("cuda", device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_count() -> int:
    """CUDA cards visible to this process."""
    return torch.cuda.device_count()


def get_device_properties(device=None) -> dict:
    """The card's properties (Paddle returns cudaDeviceProp)."""
    dev = _resolve(device)
    if dev.type != "cuda":
        return {"name": "cpu", "platform": "cpu", "id": 0,
                "memory_stats": memory_stats(dev)}
    p = torch.cuda.get_device_properties(dev)
    return {"name": p.name, "platform": "cuda", "id": dev.index,
            "total_memory": int(p.total_memory),
            "multi_processor_count": int(p.multi_processor_count),
            "capability": (int(p.major), int(p.minor)),
            "memory_stats": memory_stats(dev)}


def _synthetic_stats(dev: torch.device) -> dict:
    from .framework.scope import live_scopes

    in_use, seen = 0, set()
    for scope in live_scopes():
        for obj in list(scope._vars.values()):
            if not isinstance(obj, torch.Tensor) or obj.device.type != "cpu":
                continue
            st = obj.untyped_storage()
            if st.data_ptr() in seen:
                continue
            seen.add(st.data_ptr())
            in_use += st.nbytes()
    key = str(dev)
    peak = max(_synth_peak.get(key, 0), in_use)
    _synth_peak[key] = peak
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "bytes_limit": None, "largest_alloc_size": None,
            "num_allocs": None, "source": "synthetic"}


def memory_stats(device=None) -> dict:
    """Normalized allocator stats for one device:

      {bytes_in_use, peak_bytes_in_use, bytes_limit, largest_alloc_size,
       num_allocs, source, platform, device_id}

    ``source`` is "device" when the CUDA caching allocator answered and
    "synthetic" on the CPU (see the module docstring)."""
    dev = _resolve(device)
    if dev.type == "cuda":
        raw = torch.cuda.memory_stats(dev)
        out = {norm: (int(raw[key]) if key in raw else None)
               for norm, key in _CUDA_KEYS}
        out["bytes_in_use"] = out["bytes_in_use"] or 0
        out["peak_bytes_in_use"] = max(out["peak_bytes_in_use"] or 0,
                                       out["bytes_in_use"])
        out["bytes_limit"] = int(
            torch.cuda.get_device_properties(dev).total_memory)
        out["largest_alloc_size"] = None  # the allocator keeps no such stat
        out["source"] = "device"
        out["raw"] = {k: v for k, v in raw.items()
                      if isinstance(v, (int, float))}
        out["platform"], out["device_id"] = "cuda", dev.index
        return out
    out = _synthetic_stats(dev)
    out["platform"], out["device_id"] = dev.type, 0
    return out


def reset_peak_memory_stats(device=None) -> None:
    """Re-anchor the peak at the current bytes_in_use: the CUDA
    allocator's own peak (``torch.cuda.reset_peak_memory_stats``), or the
    synthetic source's."""
    dev = _resolve(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        return
    _synth_peak[str(dev)] = 0
    memory_stats(dev)


def synchronize(device=None) -> None:
    """Block until the device's queued work is done (Paddle's
    device_synchronize); the CPU has nothing queued."""
    dev = _resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

