"""``paddle.nn`` of the port: the Layer classes, the functional API and
the gradient-clipping classes (port of ``paddle_tpu/nn/__init__.py``).
The recurrent layers (``nn/rnn.py``) wait for their ops in ROADMAP queue
A, item A11."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, append_gradient_clip)
from .common import (
    ELU,
    GELU,
    SELU,
    AdaptiveAvgPool2D,
    AdaptiveMaxPool2D,
    AvgPool2D,
    BatchNorm,
    BatchNorm1D,
    BatchNorm2D,
    BatchNorm3D,
    BCELoss,
    BCEWithLogitsLoss,
    Conv2D,
    Conv2DTranspose,
    CrossEntropyLoss,
    Dropout,
    Dropout2D,
    Embedding,
    Flatten,
    GroupNorm,
    Hardsigmoid,
    Hardswish,
    InstanceNorm2D,
    KLDivLoss,
    L1Loss,
    LayerList,
    LayerNorm,
    LeakyReLU,
    Linear,
    LogSoftmax,
    MaxPool2D,
    Mish,
    MSELoss,
    NLLLoss,
    ParameterList,
    ReLU,
    ReLU6,
    Sequential,
    Sigmoid,
    SiLU,
    SmoothL1Loss,
    Softmax,
    Softplus,
    Swish,
    SyncBatchNorm,
    Tanh,
)
from .layers import Layer
from .transformer import (
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)

from ..framework import initializer  # paddle.nn.initializer namespace
