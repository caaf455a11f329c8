"""Static-graph layer functions (the GPT training subset).

Port of ``paddle_tpu/static/nn.py``: ``data``, ``matmul``,
``elementwise_add``, ``reshape``, ``transpose``, ``slice``, ``gelu``,
``layer_norm``, ``softmax_with_cross_entropy``, ``mean``, ``scale``,
``cast`` and ``fill_constant``, each appending the JAX package's op with
the same attrs through ``LayerHelper``. Output shapes come from the
registry's inference.
"""
from __future__ import annotations

from ..framework import LayerHelper, core
from ..framework import initializer as init
from ..framework import program as framework
from ..framework.backward import append_backward  # noqa: F401 (re-export)


def _dtype_attr(dtype) -> str:
    return dtype if isinstance(dtype, str) else core.dtype_name(dtype)


def data(name, shape, dtype="float32", lod_level=0):
    """A feed target."""
    block = framework.default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            stop_gradient=True, need_check_feed=True)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_size = 1
    for d in input.shape[begin_norm_axis:]:
        norm_size *= int(d)
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            param_attr, shape=[norm_size], dtype=input.dtype,
            default_initializer=init.ConstantInitializer(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            bias_attr, shape=[norm_size], dtype=input.dtype, is_bias=True)
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": y, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax, "Loss": loss},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"approximate": approximate})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": list(perm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return out


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"out_dtype": _dtype_attr(dtype)})
    return out


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "value": float(value),
                            "dtype": _dtype_attr(dtype)})
    return out
