"""Static-graph layer functions (fluid-style op builders).

Port of ``paddle_tpu/static/nn.py``, each builder appending the JAX
package's ops with the same attrs through ``LayerHelper`` (output shapes
come from the registry's inference): ``data``, ``fc`` (``mul`` + bias +
activation), ``embedding``, ``conv2d``, ``pool2d``, ``batch_norm`` (its
running mean and variance are non-trainable persistables that the op
writes back), ``layer_norm``, ``dropout``, ``softmax_with_cross_entropy``,
``cross_entropy``, ``mean``, ``accuracy`` (``top_k_v2`` + ``accuracy``),
the ``elementwise_*`` and unary families, ``gelu``, ``slice``,
``softmax``, ``matmul``, ``reshape``, ``transpose``, ``concat``,
``reduce_sum``/``reduce_mean``, ``scale``, ``cast`` and
``fill_constant``.

``while_loop`` and ``cond`` wait for the control-flow ops (ROADMAP queue
A, item A11) and ``sparse_embedding`` for the parameter server (A12);
each raises ``Unimplemented`` naming its item.
"""
from __future__ import annotations

from ..framework import LayerHelper, ParamAttr, core
from ..framework import errors as _errs
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


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """``mul`` over the input flattened at ``num_flatten_dims``, + bias,
    + activation."""
    helper = LayerHelper("fc", name=name)
    in_dim = _numel(input.shape[num_flatten_dims:])
    w = helper.create_parameter(param_attr, shape=[in_dim, size],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", inputs={"X": input, "Y": w},
                     outputs={"Out": out},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size],
                                    dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre_act},
                         attrs={"axis": num_flatten_dims})
        out = pre_act
    return helper.append_activation(out, act)


def embedding(input, size, param_attr=None, dtype="float32",
              is_sparse=False, padding_idx=None, name=None):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table_v2", inputs={"W": w, "Ids": input},
                     outputs={"Out": out},
                     attrs={"padding_idx": -1 if padding_idx is None
                            else padding_idx})
    return out


def sparse_embedding(input, size, name=None):
    raise _errs.errors.Unimplemented(
        "static.nn.sparse_embedding rides the parameter server's host "
        "tables, which wait in ROADMAP queue A, item A12")


def _pair(v):
    return [v, v] if isinstance(v, int) else v


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    helper = LayerHelper("conv2d", name=name)
    filter_size, stride = _pair(filter_size), _pair(stride)
    padding, dilation = _pair(padding), _pair(dilation)
    channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    g = groups or 1
    fan_in = (channels // g) * _numel(filter_size)
    w = helper.create_parameter(
        param_attr, shape=[num_filters, channels // g] + list(filter_size),
        dtype=input.dtype,
        default_initializer=init.NormalInitializer(0.0,
                                                   (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": g,
                            "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": pre},
                         attrs={"axis": 1 if data_format == "NCHW" else -1})
        out = pre
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, adaptive=False, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "exclusive": exclusive, "adaptive": adaptive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=input.dtype,
        default_initializer=init.ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=init.ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=init.ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8",
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0,
                            "dropout_implementation": dropout_implementation})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def accuracy(input, label, k=1):
    """``top_k_v2`` then ``accuracy``: the share of rows whose label is
    among the k largest scores."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_idx = helper.create_variable_for_type_inference("int64",
                                                         stop_gradient=True)
    helper.append_op("top_k_v2", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_idx},
                     attrs={"k": k, "axis": -1, "largest": True})
    acc = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    correct = helper.create_variable_for_type_inference("int32",
                                                        stop_gradient=True)
    total = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": topk_out, "Indices": topk_idx,
                             "Label": label},
                     outputs={"Accuracy": acc, "Correct": correct,
                              "Total": total})
    return acc


def _elementwise(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": axis})
        return helper.append_activation(out, act)

    fn.__name__ = op_type
    return fn


elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")


def _unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out})
        return out

    fn.__name__ = op_type
    return fn


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
sqrt = _unary("sqrt")
square = _unary("square")
exp = _unary("exp")
log = _unary("log")
abs = _unary("abs")


def softmax(x, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("softmax", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def _reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
        if dim is not None:
            attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
        helper.append_op(op_type, inputs={"X": input}, outputs={"Out": out},
                         attrs=attrs)
        return out

    fn.__name__ = op_type
    return fn


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")


def while_loop(cond, body, loop_vars, max_trip_count=None, name=None):
    raise _errs.errors.Unimplemented(
        "static.nn.while_loop: the control-flow ops (while, cond) wait in "
        "ROADMAP queue A, item A11")


def cond(pred, true_fn, false_fn, name=None):
    raise _errs.errors.Unimplemented(
        "static.nn.cond: the control-flow ops (while, cond) wait in "
        "ROADMAP queue A, item A11")
