"""paddle.save / paddle.load: pickled state-dict checkpoints.

Port of ``paddle_tpu/hapi/model_io.py``. A state dict is a name -> numpy
mapping (nested containers too); eager Tensors and torch tensors are
saved as numpy on the host (bfloat16 as its exact float32) and come back
through ``set_state_dict``.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import torch

from ..framework import core


def _to_saveable(obj):
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    obj = getattr(obj, "_value", obj)  # an eager Tensor
    if isinstance(obj, torch.Tensor):
        return core.host_numpy(obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, **kwargs) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


__all__ = ["save", "load"]
