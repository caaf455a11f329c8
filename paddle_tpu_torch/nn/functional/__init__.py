"""paddle.nn.functional of the port: dual-mode (dygraph/static) op
wrappers.

Port of ``paddle_tpu/nn/functional/__init__.py``: thin functions over
``ops.api.dispatch``, so every call is one op in either mode. The
interpolation and other functions whose ops the port does not lower yet
raise the registry's ``Unimplemented`` (ROADMAP queue A, item A11).
"""
from __future__ import annotations

from ...ops.api import dispatch, dropout, softmax  # noqa: F401
from ...ops import api as _api

# re-export elementwise/activation basics
relu = _api.relu
sigmoid = _api.sigmoid
tanh = _api.tanh
log_softmax = lambda x, axis=-1: dispatch("log_softmax", {"X": x}, {"axis": axis})


def gelu(x, approximate=False):
    return dispatch("gelu", {"X": x}, {"approximate": approximate})


def leaky_relu(x, negative_slope=0.01):
    return dispatch("leaky_relu", {"X": x}, {"alpha": float(negative_slope)})


def elu(x, alpha=1.0):
    return dispatch("elu", {"X": x}, {"alpha": float(alpha)})


def selu(x):
    return dispatch("selu", {"X": x})


def relu6(x):
    return dispatch("relu6", {"X": x})


def hardswish(x):
    return dispatch("hard_swish", {"X": x})


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return dispatch("hard_sigmoid", {"X": x}, {"slope": slope, "offset": offset})


def silu(x):
    return dispatch("silu", {"X": x})


def swish(x):
    return dispatch("swish", {"X": x})


def mish(x):
    return dispatch("mish", {"X": x})


def softplus(x):
    return dispatch("softplus", {"X": x})


def prelu(x, weight):
    return dispatch("prelu", {"X": x, "Alpha": weight})


def linear(x, weight, bias=None, name=None):
    out = dispatch("matmul_v2", {"X": x, "Y": weight}, {})
    if bias is not None:
        out = dispatch("elementwise_add", {"X": out, "Y": bias}, {"axis": -1})
    return out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW", name=None):
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    pad_algo = "EXPLICIT"
    if isinstance(padding, str):
        pad_algo, padding = padding.upper(), [0, 0]
    out = dispatch(
        "conv2d",
        {"Input": x, "Filter": weight},
        {
            "strides": list(stride), "paddings": list(padding),
            "dilations": list(dilation), "groups": groups,
            "data_format": data_format, "padding_algorithm": pad_algo,
        },
        ("Output",),
    )
    if bias is not None:
        out = dispatch(
            "elementwise_add", {"X": out, "Y": bias},
            {"axis": 1 if data_format == "NCHW" else -1},
        )
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, output_size=None, data_format="NCHW"):
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    out = dispatch(
        "conv2d_transpose",
        {"Input": x, "Filter": weight},
        {"strides": list(stride), "paddings": list(padding), "dilations": list(dilation), "groups": groups},
        ("Output",),
    )
    if bias is not None:
        out = dispatch("elementwise_add", {"X": out, "Y": bias}, {"axis": 1})
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False, data_format="NCHW"):
    return _pool2d(x, kernel_size, "max", stride, padding)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True, data_format="NCHW"):
    return _pool2d(x, kernel_size, "avg", stride, padding, exclusive)


def _pool2d(x, ksize, ptype, stride=None, padding=0, exclusive=True):
    if isinstance(ksize, int):
        ksize = [ksize, ksize]
    stride = stride or ksize
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    return dispatch(
        "pool2d", {"X": x},
        {"pooling_type": ptype, "ksize": list(ksize), "strides": list(stride),
         "paddings": list(padding), "exclusive": exclusive},
    )


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    if isinstance(output_size, int):
        output_size = [output_size, output_size]
    return dispatch(
        "pool2d", {"X": x},
        {"pooling_type": "avg", "ksize": list(output_size), "adaptive": True},
    )


def adaptive_max_pool2d(x, output_size):
    if isinstance(output_size, int):
        output_size = [output_size, output_size]
    return dispatch(
        "pool2d", {"X": x},
        {"pooling_type": "max", "ksize": list(output_size), "adaptive": True},
    )


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return dispatch(
        "lookup_table_v2", {"W": weight, "Ids": x},
        {"padding_idx": -1 if padding_idx is None else padding_idx},
    )


def one_hot(x, num_classes):
    return _api.one_hot(x, num_classes)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    ndim = len(x.shape)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = ndim - len(normalized_shape)
    ins = {"X": x}
    if weight is not None:
        ins["Scale"] = weight
    if bias is not None:
        ins["Bias"] = bias
    return dispatch(
        "layer_norm", ins, {"epsilon": epsilon, "begin_norm_axis": begin},
        ("Y", "Mean", "Variance"),
    )[0]


def batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    return dispatch(
        "batch_norm",
        {"X": x, "Scale": weight, "Bias": bias, "Mean": running_mean, "Variance": running_var},
        {"momentum": momentum, "epsilon": epsilon, "is_test": not training, "data_layout": data_format},
        ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
    )[0]


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean", soft_label=False, axis=-1):
    loss = dispatch(
        "softmax_with_cross_entropy",
        {"Logits": input, "Label": label},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
        ("Softmax", "Loss"),
    )[1]
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100, return_softmax=False, axis=-1):
    sm, loss = dispatch(
        "softmax_with_cross_entropy",
        {"Logits": logits, "Label": label},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
        ("Softmax", "Loss"),
    )
    return (loss, sm) if return_softmax else loss


def mse_loss(input, label, reduction="mean"):
    loss = dispatch("mse_loss", {"X": input, "Label": label}, {})
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def l1_loss(input, label, reduction="mean"):
    loss = dispatch("l1_loss", {"X": input, "Y": label}, {})
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    loss = dispatch("bce_loss", {"X": input, "Label": label}, {})
    if weight is not None:
        loss = _api.multiply(loss, weight)
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean", pos_weight=None):
    loss = dispatch("sigmoid_cross_entropy_with_logits", {"X": logit, "Label": label}, {})
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    return dispatch("nll_loss", {"X": input, "Label": label}, {"reduction": reduction}, ("Out", "Total_weight"))[0]


def kl_div(input, label, reduction="mean"):
    return dispatch("kldiv_loss", {"X": input, "Target": label}, {"reduction": reduction}, ("Loss",))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    loss = dispatch("huber_loss", {"X": input, "Y": label}, {"delta": delta}, ("Out", "Residual"))[0]
    if reduction == "mean":
        return _api.mean(loss)
    if reduction == "sum":
        return _api.sum(loss)
    return loss


def normalize(x, p=2, axis=1, epsilon=1e-12):
    norm = dispatch("p_norm", {"X": x}, {"porder": float(p), "axis": axis, "keepdim": True})
    return _api.divide(x, _api.clip(norm, min=epsilon))


def pad(x, pad, mode="constant", value=0.0, data_format="NCDHW"):
    if len(pad) == len(x.shape) * 2:
        return dispatch("pad", {"X": x}, {"paddings": list(pad), "pad_value": float(value)})
    return dispatch("pad3d", {"X": x}, {"paddings": list(pad), "mode": mode, "value": float(value)})


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False, data_format="NCHW"):
    attrs = {"align_corners": align_corners}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    if scale_factor is not None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor, scale_factor]
        attrs["scale"] = [float(s) for s in sf]
        attrs.setdefault("out_h", -1)
        attrs.setdefault("out_w", -1)
    op = "bilinear_interp_v2" if mode == "bilinear" else "nearest_interp_v2"
    return dispatch(op, {"X": x}, attrs)


upsample = interpolate


def label_smooth(label, prior_dist=None, epsilon=0.1):
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    return dispatch("label_smooth", ins, {"epsilon": float(epsilon)})


def sequence_mask(lengths, maxlen, dtype="int64"):
    return dispatch("sequence_mask", {"X": lengths}, {"maxlen": int(maxlen), "out_dtype": dtype}, ("Y",))


def pixel_shuffle(x, upscale_factor):
    return dispatch("pixel_shuffle", {"X": x}, {"upscale_factor": upscale_factor})


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True):
    return dispatch("grid_sampler", {"X": x, "Grid": grid}, {}, ("Output",))


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, training=True):
    """Fused attention: one ``fused_attention_tpu`` op, which takes the
    flash kernels where the reference takes its pallas flash path (never
    ``torch.nn.functional.scaled_dot_product_attention``)."""
    from ...ops import attention as _attn

    return _attn.scaled_dot_product_attention(q, k, v, attn_mask, dropout_p, is_causal, training)
