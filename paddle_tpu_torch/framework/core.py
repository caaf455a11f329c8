"""Core runtime types: dtypes and Places.

Port of ``paddle_tpu/framework/core.py``. A dtype is a ``torch.dtype``;
the program descs keep the JAX package's dtype *names* ('float32',
'bfloat16', 'int64', ...), so the same attrs read the same in both
packages. A Place names a torch device: :class:`CUDAPlace` (the default)
or :class:`CPUPlace`. :func:`set_device` / :func:`get_device` choose and
name the default place, as the JAX package's do (``"tpu"`` names the
card too, so the reference's scripts keep working).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from . import errors as _errs

__all__ = ["Place", "CPUPlace", "CUDAPlace", "default_place", "set_device",
           "get_device", "convert_dtype", "dtype_name", "is_floating",
           "host_numpy"]

_NAME_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "double": torch.float64,
}
_TORCH_TO_NAME = {
    torch.bool: "bool", torch.int8: "int8", torch.uint8: "uint8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
}


def convert_dtype(dtype: Any) -> torch.dtype:
    """str | torch dtype | numpy dtype (ml_dtypes bfloat16 included) ->
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:  # a numpy scalar type such as np.float32
        name = getattr(dtype, "__name__", str(dtype))
    try:
        return _NAME_TO_TORCH[str(name)]
    except KeyError:
        raise _errs.errors.InvalidArgument(
            f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype: Any) -> str:
    """The JAX package's name of a dtype ('float32', 'bfloat16', ...)."""
    return _TORCH_TO_NAME[convert_dtype(dtype)]


def is_floating(dtype: Any) -> bool:
    return convert_dtype(dtype).is_floating_point


def host_numpy(t: torch.Tensor):
    """A tensor's values as a numpy array of their own on the host (never
    a view of a CPU tensor that a later in-place update would change);
    bfloat16 as its exact float32 (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class Place:
    """A torch device: ``CUDAPlace(i)`` -> ``cuda:i``, ``CPUPlace()`` ->
    ``cpu``."""

    device_type = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device(self.device_type, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    """The port's first-class device (the JAX package's ``TPUPlace``)."""

    device_type = "cuda"


_default_place: Optional[Place] = None

# device names of set_device: the card's (the JAX package's "tpu" and
# "gpu" among them) and the host's
_CARD_NAMES = ("gpu", "cuda", "tpu")


def set_device(device: str) -> Place:
    """``paddle.set_device``: ``"gpu"``, ``"cuda"`` or ``"tpu"`` (with an
    optional ``":<i>"``) make ``CUDAPlace(i)`` the default place, ``"cpu"``
    ``CPUPlace``. Returns the place. Nothing is checked here: with no card,
    an entry point on the default place raises ``errors.Unavailable``."""
    global _default_place
    name, _, idx = str(device).strip().lower().partition(":")
    idx = int(idx) if idx else 0
    if name in _CARD_NAMES:
        _default_place = CUDAPlace(idx)
    elif name == "cpu":
        _default_place = CPUPlace(idx)
    else:
        raise _errs.errors.InvalidArgument(
            f"unknown device {device!r}: expected gpu, cuda, tpu (each "
            f"with an optional :<index>) or cpu")
    return _default_place


def get_device() -> str:
    """The default place's name: ``"gpu:<i>"`` or ``"cpu"``."""
    p = default_place()
    return "cpu" if isinstance(p, CPUPlace) else f"gpu:{p.device_id}"


def default_place() -> Place:
    """The place :func:`set_device` chose, else ``PADDLE_TPU_DEFAULT_DEVICE``
    (read once, as the JAX package reads it), else ``CUDAPlace(0)``: entry
    points run on the card unless the caller asks for the CPU. There is no
    fallback to the CPU when no card is present."""
    if _default_place is None:
        from .. import flags as _flags

        forced = _flags.env_flag("PADDLE_TPU_DEFAULT_DEVICE")
        if forced:
            set_device(forced)
        else:
            return CUDAPlace(0)
    return _default_place


def resolve_device(place: Place) -> torch.device:
    """The torch device of a place; a CUDA place with no usable card
    raises ``errors.Unavailable`` (never a quiet CPU fallback)."""
    dev = place.torch_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise _errs.errors.Unavailable(
            "paddle_tpu_torch runs programs on a CUDA card and none is "
            "available; pass CPUPlace() to run on the CPU")
    return dev
