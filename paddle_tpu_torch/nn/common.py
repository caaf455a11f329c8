"""Common nn layers.

Port of ``paddle_tpu/nn/common.py``: Layer classes over the functional
API (Linear, Embedding, LayerNorm, Dropout, the activations, the
containers and the losses), dual-mode through LayerHelper's parameter
creation. The convolution, pooling and normalization classes run the
ops of ``ops/nn_ops.py`` (``conv2d``, ``conv2d_transpose``, ``pool2d``,
``batch_norm``, ``group_norm``, ``instance_norm``); a BatchNorm's running
mean and variance are parameters with ``trainable=False``, which its op
writes in place of the old values at each training forward.
"""
from __future__ import annotations

import numpy as np

from ..framework import ParamAttr
from ..framework import initializer as I
from . import functional as F
from .layers import Layer


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierInitializer(),
        )
        self.bias = (
            self.create_parameter(shape=[out_features], attr=bias_attr, is_bias=True)
            if bias_attr is not False
            else None
        )

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2D(Layer):
    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size,
        stride=1,
        padding=0,
        dilation=1,
        groups=1,
        padding_mode="zeros",
        weight_attr=None,
        bias_attr=None,
        data_format="NCHW",
    ):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = [kernel_size, kernel_size]
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups or 1
        self._data_format = data_format
        fan_in = (in_channels // self._groups) * int(np.prod(kernel_size))
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // self._groups] + list(kernel_size),
            attr=weight_attr,
            default_initializer=I.NormalInitializer(0.0, (2.0 / fan_in) ** 0.5),
        )
        self.bias = (
            self.create_parameter(shape=[out_channels], attr=bias_attr, is_bias=True)
            if bias_attr is not False
            else None
        )

    def forward(self, x):
        return F.conv2d(
            x, self.weight, self.bias, self._stride, self._padding,
            self._dilation, self._groups, self._data_format,
        )


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = [kernel_size, kernel_size]
        self._stride, self._padding, self._dilation, self._groups = stride, padding, dilation, groups or 1
        self.weight = self.create_parameter(
            shape=[in_channels, out_channels // self._groups] + list(kernel_size),
            attr=weight_attr, default_initializer=I.XavierInitializer(),
        )
        self.bias = (
            self.create_parameter(shape=[out_channels], attr=bias_attr, is_bias=True)
            if bias_attr is not False else None
        )

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding, self._dilation, self._groups)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierInitializer(),
        )

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None, bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = "NCHW" if data_format in ("NCHW", "NCL", "NCDHW") else "NHWC"
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.ConstantInitializer(1.0),
        )
        self.bias = self.create_parameter(shape=[num_features], attr=bias_attr, is_bias=True)
        helper_attr = ParamAttr(trainable=False)
        self._mean = self.create_parameter(
            shape=[num_features], attr=helper_attr,
            default_initializer=I.ConstantInitializer(0.0),
        )
        self._variance = self.create_parameter(
            shape=[num_features], attr=ParamAttr(trainable=False),
            default_initializer=I.ConstantInitializer(1.0),
        )
        self._mean.stop_gradient = True
        self._variance.stop_gradient = True

    def forward(self, x):
        from ..framework import LayerHelper
        from ..framework import program as framework

        attrs = {
            "momentum": self._momentum, "epsilon": self._epsilon,
            "is_test": not self.training,
            "data_layout": self._data_format,
            "use_global_stats": bool(self._use_global_stats),
        }
        inputs = {
            "X": x, "Scale": self.weight, "Bias": self.bias,
            "Mean": self._mean, "Variance": self._variance,
        }
        helper = LayerHelper("batch_norm")
        y = helper.create_variable_for_type_inference(getattr(x, "dtype", "float32"))
        saved_m = helper.create_variable_for_type_inference("float32", stop_gradient=True)
        saved_v = helper.create_variable_for_type_inference("float32", stop_gradient=True)
        # MeanOut/VarianceOut write the running-stat state in place: the
        # tracer swaps the tensors' values (dygraph) / the executor stores
        # the persistable vars back (static)
        helper.append_op(
            "batch_norm",
            inputs=inputs,
            outputs={
                "Y": y, "MeanOut": self._mean, "VarianceOut": self._variance,
                "SavedMean": saved_m, "SavedVariance": saved_v,
            },
            attrs=attrs,
        )
        return y


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN; on one card it equals BatchNorm (the mesh waits
    for A10)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm.__new__(SyncBatchNorm)
            new.__dict__.update(layer.__dict__)
            return new
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = int(np.prod(normalized_shape))
        self.weight = (
            self.create_parameter(shape=[n], attr=weight_attr, default_initializer=I.ConstantInitializer(1.0))
            if weight_attr is not False else None
        )
        self.bias = (
            self.create_parameter(shape=[n], attr=bias_attr, is_bias=True)
            if bias_attr is not False else None
        )

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None, bias_attr=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(shape=[num_channels], attr=weight_attr, default_initializer=I.ConstantInitializer(1.0))
        self.bias = self.create_parameter(shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        from ..ops.api import dispatch

        return dispatch(
            "group_norm",
            {"X": x, "Scale": self.weight, "Bias": self.bias},
            {"groups": self._num_groups, "epsilon": self._epsilon},
            ("Y", "Mean", "Variance"),
        )[0]


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, weight_attr=None, bias_attr=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = self.create_parameter(shape=[num_features], attr=weight_attr, default_initializer=I.ConstantInitializer(1.0))
        self.bias = self.create_parameter(shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        from ..ops.api import dispatch

        return dispatch(
            "instance_norm", {"X": x, "Scale": self.scale, "Bias": self.bias},
            {"epsilon": self._epsilon}, ("Y", "SavedMean", "SavedVariance"),
        )[0]


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Dropout2D(Dropout):
    pass


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ..ops.api import flatten

        return flatten(x, self.start_axis, self.stop_axis)


# -- activations ------------------------------------------------------------


def _act_layer(name, fn):
    class _Act(Layer):
        def __init__(self, *a, **kw):
            super().__init__()
            self._a, self._kw = a, kw

        def forward(self, x):
            return fn(x, *self._a, **self._kw)

    _Act.__name__ = name
    return _Act


ReLU = _act_layer("ReLU", lambda x: F.relu(x))
GELU = _act_layer("GELU", F.gelu)
Sigmoid = _act_layer("Sigmoid", lambda x: F.sigmoid(x))
Tanh = _act_layer("Tanh", lambda x: F.tanh(x))
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
ReLU6 = _act_layer("ReLU6", lambda x: F.relu6(x))
SiLU = _act_layer("SiLU", lambda x: F.silu(x))
Swish = _act_layer("Swish", lambda x: F.swish(x))
Mish = _act_layer("Mish", lambda x: F.mish(x))
Hardswish = _act_layer("Hardswish", lambda x: F.hardswish(x))
Hardsigmoid = _act_layer("Hardsigmoid", lambda x: F.hardsigmoid(x))
ELU = _act_layer("ELU", F.elu)
SELU = _act_layer("SELU", lambda x: F.selu(x))
Softplus = _act_layer("Softplus", lambda x: F.softplus(x))


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


# -- pooling ----------------------------------------------------------------


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


# -- containers (reference dygraph/container.py) ----------------------------


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and not isinstance(layers[0], Layer):
            layers = layers[0]
        for i, l in enumerate(layers):
            if isinstance(l, tuple):
                self.add_sublayer(l[0], l[1])
            else:
                self.add_sublayer(str(i), l)

    def forward(self, x):
        for l in self._sub_layers.values():
            x = l(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or []):
            self.add_sublayer(str(i), l)

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)


# -- losses (reference python/paddle/nn/layer/loss.py) ----------------------


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False, axis=-1):
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label, axis=self.axis,
        )


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, reduction=self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.reduction = reduction
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.nll_loss(input, label, ignore_index=self.ignore_index, reduction=self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)
