"""nn.Layer base class.

Port of ``paddle_tpu/nn/layers.py``: parameter and sublayer registries,
forward hooks, train/eval state and ``state_dict``/``set_state_dict``
under the reference's structured names (``layers.0.self_attn.q_proj
.weight``). Works in dygraph (parameters are eager Tensors) and as a
builder in static mode (parameters are program Parameters). A state dict
holds numpy arrays (a bfloat16 value as its exact float32);
``set_state_dict`` copies each value into the parameter's own tensor, in
its dtype and on its device.
"""
from __future__ import annotations

import collections
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from ..framework import LayerHelper, core, unique_name
from ..framework import program as framework


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype: str = "float32"):
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower()
        )
        self._dtype = dtype
        self.training = True
        self._parameters: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._sub_layers: "collections.OrderedDict[str, Layer]" = collections.OrderedDict()
        self._buffers: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()

    # -- naming ---------------------------------------------------------
    def full_name(self) -> str:
        return self._full_name

    # -- parameter/sublayer registration -------------------------------
    def __setattr__(self, name: str, value: Any):
        from ..dygraph.varbase import Parameter as EagerParameter

        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(value, (framework.Parameter, EagerParameter)):
            params[name] = value
            self.__dict__.pop(name, None)
        elif layers is not None and isinstance(value, Layer):
            layers[name] = value
            self.__dict__.pop(name, None)
        else:
            if params is not None and name in params:
                del params[name]
            if layers is not None and name in layers:
                del layers[name]
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        if "_parameters" in self.__dict__ and name in self.__dict__["_parameters"]:
            return self.__dict__["_parameters"][name]
        if "_sub_layers" in self.__dict__ and name in self.__dict__["_sub_layers"]:
            return self.__dict__["_sub_layers"][name]
        if "_buffers" in self.__dict__ and name in self.__dict__["_buffers"]:
            return self.__dict__["_buffers"][name]
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    def add_parameter(self, name: str, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        self._buffers[name] = tensor
        return tensor

    def create_parameter(
        self,
        shape,
        attr=None,
        dtype=None,
        is_bias: bool = False,
        default_initializer=None,
    ):
        helper = LayerHelper(self._full_name)
        return helper.create_parameter(
            attr, shape, dtype or self._dtype, is_bias, default_initializer
        )

    # -- traversal ------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List:
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "", include_sublayers: bool = True):
        seen = set()
        for name, p in self._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                for n, p in layer.named_parameters(sub_prefix, True):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        out = [self] if include_self else []
        for l in self._sub_layers.values():
            out.extend(l.sublayers(include_self=True))
        return out

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        if include_self:
            yield prefix, self
        for name, l in self._sub_layers.items():
            sub = f"{prefix}.{name}" if prefix else name
            yield from l.named_sublayers(sub, include_self=True)

    def children(self) -> Iterator["Layer"]:
        return iter(self._sub_layers.values())

    def named_children(self):
        return iter(self._sub_layers.items())

    def apply(self, fn):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # -- mode -----------------------------------------------------------
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        tracer = framework._current_tracer()
        if tracer is not None:
            tracer.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        tracer = framework._current_tracer()
        if tracer is not None:
            tracer.training = False
        return self

    # -- forward --------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, args)
            if result is not None:
                args = result if isinstance(result, tuple) else (result,)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, args, out)
            if result is not None:
                out = result
        return out

    def register_forward_pre_hook(self, hook):
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_post_hook(self, hook):
        handle = _HookHandle(self._forward_post_hooks)
        self._forward_post_hooks[handle.id] = hook
        return handle

    # -- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   prefix: str = ""):
        dest = destination if destination is not None else \
            collections.OrderedDict()
        from ..framework.scope import global_scope

        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            val = getattr(p, "_value", None)
            if val is None:
                val = global_scope().get(p.name)
            dest[name] = None if val is None else _host(val)
        for name, b in self._buffers.items():
            key = f"{prefix}.{name}" if prefix else name
            if getattr(b, "_value", None) is not None:
                dest[key] = _host(b._value)
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each value into the parameter (or buffer) of its
        structured name, else of its variable name; returns the names
        that matched nothing."""
        from ..framework.scope import global_scope

        own = dict(self.named_parameters())
        byvar = {q.name: q for q in own.values()}
        missing = []
        for name, value in state_dict.items():
            p = next((c for c in (own.get(name), byvar.get(name),
                                  self._buffers.get(name)) if c is not None),
                     None)
            if p is None:
                missing.append(name)
                continue
            cur = getattr(p, "_value", None)
            if cur is not None:
                with torch.no_grad():
                    cur.copy_(_as_torch(value))
            else:
                global_scope().set(p.name, np.asarray(value))
        return missing

    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            if getattr(p, "grad", None) is not None:
                p.clear_grad()

    def __repr__(self):
        extra = []
        for name, l in self._sub_layers.items():
            extra.append(f"  ({name}): {type(l).__name__}")
        inner = "\n".join(extra)
        return f"{type(self).__name__}(\n{inner}\n)" if inner else f"{type(self).__name__}()"


def _host(value) -> np.ndarray:
    """A value as a numpy copy on the host; bfloat16 as its exact
    float32."""
    if isinstance(value, torch.Tensor):
        return core.host_numpy(value)
    return np.array(value)


def _as_torch(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    if hasattr(value, "_value"):
        return value._value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class _HookHandle:
    _next_id = 0

    def __init__(self, registry):
        self.registry = registry
        self.id = _HookHandle._next_id
        _HookHandle._next_id += 1

    def remove(self):
        self.registry.pop(self.id, None)
