"""Optimizer op lowerings: ``sgd``, ``adam`` and ``adamw``.

Port of ``paddle_tpu/ops/optimizer_ops.py``. ``register_optimizer`` keeps
the JAX package's fp32 master arithmetic: inputs are widened to fp32 for
the update and each ``<Slot>Out`` is cast back to its ``<Slot>`` input's
dtype. The JAX package's ``adam``/``adamw`` take their fused pallas
kernel only for tile-aligned 2-D params on a TPU; the port's take the
fused CUDA kernel (``ops/fused_adam.py``) for every param, so no plain
update runs on the card, and the beta-pow updates stay here, in the
lowering, as in ``_adam_fused_maybe``. The kernel updates p and the
moments in place, the lowering multiplies the beta powers in place after
the kernel has read them (in order on one stream), and the op returns
those same tensors. In place is what a step replayed as a CUDA graph
needs: the graph reads each persistable at its captured address, so a
new tensor returned for ``Beta1PowOut`` would never reach the next step
(the executor would have to copy it back, two launches a parameter).
"""
from __future__ import annotations

from ..framework.registry import register_op
from . import fused_adam as _fa


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def register_optimizer(name):
    """register_op for update rules with fp32 master arithmetic."""

    def deco(fn):
        def wrapped(ctx, ins, attrs):
            f32_ins = {slot: [a.float() if a.dtype.is_floating_point else a
                              for a in arrs]
                       for slot, arrs in ins.items()}
            res = {}
            for slot, val in fn(ctx, f32_ins, attrs).items():
                ref = ins.get(slot[:-3] if slot.endswith("Out") else slot)
                res[slot] = val.to(ref[0].dtype) if ref is not None else val
            return res

        wrapped.__name__ = fn.__name__
        return register_op(name, stop_gradient=True)(wrapped)

    return deco


@register_optimizer("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": p - _lr(ins) * g}


def _adam_fused(ins, attrs, weight_decay):
    """One fused Adam(W) step through the kernel wrapper (in place)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    p_out, m1_out, m2_out = _fa.fused_adam(
        p, g.contiguous(), m1, m2, ins["LearningRate"][0].float(),
        b1p.float(), b2p.float(), beta1=b1, beta2=b2,
        eps=attrs.get("epsilon", 1e-8), weight_decay=weight_decay)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            "Beta1PowOut": b1p.mul_(b1), "Beta2PowOut": b2p.mul_(b2)}


# an update op's outputs are its inputs' vars: nothing to infer, and the
# kernel wrapper never sees a meta tensor
@register_op("adam", stop_gradient=True, skip_infer=True)
def _adam(ctx, ins, attrs):
    return _adam_fused(ins, attrs, 0.0)


@register_op("adamw", stop_gradient=True, skip_infer=True)
def _adamw(ctx, ins, attrs):
    coeff = attrs.get("coeff", 0.01) if attrs.get("with_decay", True) else 0.0
    return _adam_fused(ins, attrs, coeff)
