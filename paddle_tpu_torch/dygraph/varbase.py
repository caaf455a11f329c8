"""Dygraph Tensor (VarBase) and Parameter.

Port of ``paddle_tpu/dygraph/varbase.py``: an eager tensor holding a
device value, a ``stop_gradient`` flag and an accumulated ``.grad``. The
value is a ``torch.Tensor`` on an explicit device: the default place
(``framework/core.py``: the card, which raises where there is none) or
the CPU when the caller asks for it (``place="cpu"``, ``set_device``).
Ops never write into a value they did not create: an op's output is a
new tensor and the tracer swaps it in, as the reference swaps its
immutable ``jax.Array``; the in-place optimizer updates (the fused Adam
kernel) hand back the parameter's own tensor, updated where it lies.

``numpy()`` of a bfloat16 tensor gives the exact float32 of its values:
numpy has no bfloat16 (the reference hands out ml_dtypes' bfloat16).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..framework import core, unique_name


def _place_device(place) -> torch.device:
    """The torch device of ``place`` (a Place, a device name such as
    "cpu" or "gpu:0", a torch device) or of the default place."""
    if place is None:
        place = core.default_place()
    elif isinstance(place, str):
        name = place.strip().lower()
        place = (core.CPUPlace() if name == "cpu" else core.CUDAPlace(
            int(name.partition(":")[2] or 0)))
    elif isinstance(place, torch.device):
        place = (core.CPUPlace() if place.type == "cpu"
                 else core.CUDAPlace(place.index or 0))
    return core.resolve_device(place)


def to_torch(value: Any, dtype=None, place=None) -> torch.Tensor:
    """``value`` (a tensor, a numpy array, a list or a scalar) as a torch
    tensor on ``place``'s device. A float64 array becomes float32 and an
    ml_dtypes bfloat16 array torch bfloat16, exactly: the reference's
    dtypes with 64-bit floats off. ``dtype`` casts."""
    if isinstance(value, Tensor):
        value = value._value
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if place is not None:
            t = t.to(_place_device(place))
    else:
        arr = np.asarray(value)
        bf16 = arr.dtype.name == "bfloat16"
        if bf16:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, order="C"))
        if bf16:
            t = t.to(torch.bfloat16)
        t = t.to(_place_device(place))
    if dtype is not None:
        t = t.to(core.convert_dtype(dtype))
    return t


class Tensor:
    def __init__(self, value: Any = None, name: Optional[str] = None,
                 stop_gradient: bool = True, persistable: bool = False,
                 trainable: bool = True, dtype=None, place=None):
        self._value = (None if value is None
                       else to_torch(value, dtype, place))
        self.name = name or unique_name.generate("eager_tmp")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = trainable
        self.grad: Optional["Tensor"] = None
        self.regularizer = None
        self.need_clip = True
        self.is_leaf = True

    @classmethod
    def _wrap(cls, value: torch.Tensor, stop_gradient: bool = True
              ) -> "Tensor":
        """A Tensor around an op's output as it is (no copy, no cast)."""
        t = cls.__new__(cls)
        t._value = value
        t.name = unique_name.generate("eager_tmp")
        t.stop_gradient = stop_gradient
        t.persistable = False
        t.trainable = True
        t.grad = None
        t.regularizer = None
        t.need_clip = True
        t.is_leaf = True
        return t

    # -- basic properties ----------------------------------------------
    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def place(self) -> torch.device:
        return self._value.device

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def size(self):
        return int(self._value.numel())

    def numpy(self) -> np.ndarray:
        """The value as numpy on the host (a copy); bfloat16 as its exact
        float32."""
        return core.host_numpy(self._value)

    def item(self):
        return self.numpy().item()

    def numel(self):
        return self.size

    # -- autograd -------------------------------------------------------
    def backward(self, grad_tensor: Optional["Tensor"] = None,
                 retain_graph: bool = False):
        from ..framework import program as framework

        tracer = framework._current_tracer()
        if tracer is None:
            raise RuntimeError("backward() outside dygraph mode")
        tracer.run_backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._value, stop_gradient=True)

    def clone(self) -> "Tensor":
        from ..ops.api import assign

        return assign(self)

    def set_value(self, value):
        """Replace the value, keeping this tensor's dtype and device."""
        cur = self._value
        self._value = to_torch(value).to(
            device=cur.device, dtype=cur.dtype) if cur is not None \
            else to_torch(value)

    def gradient(self):
        """The gradient as numpy (reference ``VarBase.gradient``)."""
        return None if self.grad is None else self.grad.numpy()

    # -- conversion sugar ----------------------------------------------
    def astype(self, dtype):
        from ..ops.api import cast

        return cast(self, dtype)

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._value.cpu(), self.stop_gradient)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        g = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}{g},\n       {self._value})")

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype else arr

    def __getitem__(self, idx):
        from ..ops import api

        return api._tensor_getitem(self, idx)

    # the math dunders are installed by ops.api.monkey_patch()

    @property
    def is_parameter(self):
        return self.persistable and self.trainable


class Parameter(Tensor):
    """Trainable dygraph tensor (reference ParamBase)."""

    def __init__(self, value=None, name=None, trainable=True, **kw):
        super().__init__(value, name=name, stop_gradient=not trainable,
                         persistable=True, trainable=trainable, **kw)
