"""Parameters from the JAX package (or a checkpoint) into the port.

The two packages name and lay out their GPT parameters the same way
(``serving/model.py:init_params``): ``gpt.wte`` is ``[V, D]``,
``gpt.wpe`` is ``[T, D]``, every linear weight such as
``gpt.h<i>.attn.q.w`` is ``[d_in, d_out]`` (applied as ``x @ w + b``),
and layer norms carry ``.scale`` / ``.bias``. So a dict of numpy arrays
moves over unchanged, and both packages compute the same function.

For static-graph training, :func:`scope_from_numpy` places the JAX
scope's parameters and optimizer state (names unchanged: ``gpt.wte``,
``gpt.wte_moment1_0``, ``adam_0``'s beta powers ...) in the port's
``Scope``, so that both packages start a step from the same values.
Random streams are never matched: the values are copied.

For the eager API, :func:`layer_from_numpy` carries a network across: the
JAX package's ``nn.Layer.state_dict()`` (numpy, under the structured
names both packages give the same layers, ``layers.0.self_attn.q_proj
.weight``) goes into the port's ``Layer.set_state_dict``, and
:func:`optimizer_from_numpy` seeds an eager optimizer's accumulators from
the reference's per-parameter optimizer state (keyed by the same
structured names, as ``checkpoint.py`` saves it), so that both packages
continue from the same moments.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["layer_from_numpy", "optimizer_from_numpy", "params_from_numpy",
           "scope_from_numpy", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the JAX package's configs ('float32', ...) as a
    torch dtype; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def params_from_numpy(params: Dict[str, np.ndarray], device,
                      dtype: Optional[object] = None
                      ) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``,
    same names and layouts, cast to ``dtype`` when given (a torch dtype
    or a name like 'float32'), else kept. Arrays of the ml_dtypes
    bfloat16 type that JAX hands out become torch bfloat16 exactly."""
    device = torch.device(device)
    want = None if dtype is None else torch_dtype(dtype)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in params.items():
        a = np.asarray(arr)
        bf16 = a.dtype.name == "bfloat16"
        if bf16:  # numpy cannot hand torch this dtype: widen exactly
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        if bf16 and want is None:
            t = t.to(torch.bfloat16)
        out[name] = t.to(device=device, dtype=want).contiguous()
    return out


def scope_from_numpy(values: Dict[str, np.ndarray], scope, device):
    """Put ``{name: np.ndarray}`` into ``scope`` as tensors on ``device``,
    names and dtypes unchanged (ml_dtypes bfloat16 becomes torch bfloat16
    exactly): parameters, optimizer state and the static AMP's
    persistables (``@AMP.loss_scaling``, and ``@AMP.good_steps`` /
    ``@AMP.bad_steps``, float32 at the start and int32 after a step, as
    ``update_loss_scaling`` writes them). Returns the scope."""
    for name, t in params_from_numpy(values, device).items():
        scope.set(name, t)
    return scope


def layer_from_numpy(layer, state: Dict[str, np.ndarray]):
    """Copy ``state`` (a JAX ``nn.Layer.state_dict()``: structured name ->
    numpy) into the port's ``layer``, each value in its parameter's dtype
    and on its device. Every parameter must be given and every name must
    match one; raises ``KeyError`` otherwise. The parameters include the
    non-trainable ones, a BatchNorm's running mean and variance
    (``bn1._mean``, ``bn1._variance``), so an eager ResNet moves across
    whole. Returns the layer."""
    own = {name for name, _ in layer.named_parameters()}
    missing = sorted(own - set(state))
    unknown = layer.set_state_dict({k: np.asarray(v)
                                    for k, v in state.items()})
    if missing or unknown:
        raise KeyError(f"layer_from_numpy: parameters not given {missing}, "
                       f"names that match no parameter {unknown}")
    return layer


def optimizer_from_numpy(optimizer, network, accumulators) -> None:
    """Seed ``optimizer``'s eager accumulators from ``accumulators``:
    ``{slot: {structured parameter name: value}}`` (a value may be a
    record ``{"value": ...}``, as ``checkpoint.TrainCheckpointer`` stores
    it); the first ``step`` then updates on those moments."""
    from .checkpoint import TrainCheckpointer

    structured = {slot: {key: (rec if isinstance(rec, dict)
                               else {"value": np.asarray(rec)})
                         for key, rec in per.items()}
                  for slot, per in accumulators.items()}
    TrainCheckpointer._restore_accumulators(optimizer, structured,
                                            network=network)
