"""Weight-decay regularizers: ``L2Decay``, ``L1Decay`` and
``append_regularization_grads``.

Port of ``paddle_tpu/regularizer.py``, op for op: a decay term is added
to a gradient before the optimizer's update (L2: ``scale`` of the
parameter, ``elementwise_add``; L1: ``sign``, ``scale``,
``elementwise_add``). A parameter's own regularizer (``ParamAttr``)
overrides the optimizer's default, and a float default is ``L2Decay`` of
that coefficient.
"""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "append_regularization_grads"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def __call__(self, param, grad, block):
        if self._coeff == 0.0:
            return grad
        from .framework import LayerHelper

        helper = LayerHelper("l2_decay")
        decayed = helper.create_variable_for_type_inference(grad.dtype)
        scaled = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("scale", inputs={"X": param},
                         outputs={"Out": scaled},
                         attrs={"scale": self._coeff})
        helper.append_op("elementwise_add", inputs={"X": grad, "Y": scaled},
                         outputs={"Out": decayed})
        return decayed


class L1Decay(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def __call__(self, param, grad, block):
        if self._coeff == 0.0:
            return grad
        from .framework import LayerHelper

        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(grad.dtype)
        scaled = helper.create_variable_for_type_inference(grad.dtype)
        out = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("sign", inputs={"X": param}, outputs={"Out": sign})
        helper.append_op("scale", inputs={"X": sign}, outputs={"Out": scaled},
                         attrs={"scale": self._coeff})
        helper.append_op("elementwise_add", inputs={"X": grad, "Y": scaled},
                         outputs={"Out": out})
        return out


def append_regularization_grads(params_grads, default_regularizer=None):
    """Each (param, grad) with the decay of the param's own regularizer,
    else of ``default_regularizer`` (a float means ``L2Decay``)."""
    if default_regularizer is None and not any(
            getattr(p, "regularizer", None) for p, _ in params_grads):
        return params_grads
    if isinstance(default_regularizer, float):
        default_regularizer = L2Decay(default_regularizer)
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or default_regularizer
        if reg is None or g is None:
            out.append((p, g))
        else:
            out.append((p, reg(p, g, None)))
    return out
