"""paddle.vision of the port: the model zoo, transforms and datasets.

Port of ``paddle_tpu/vision/``: the models (``models/``: LeNet, VGG,
ResNet, MobileNet v1 and v2) are copies over the port's ``nn`` layers,
whose convolution, pooling and batch-norm ops run through
``ops/nn_ops.py``; ``transforms.py`` and ``datasets.py`` are numpy on the
host, as there.
"""
from . import datasets, models, transforms  # noqa: F401
from .models import (  # noqa: F401
    LeNet,
    MobileNetV1,
    MobileNetV2,
    ResNet,
    VGG,
    mobilenet_v1,
    mobilenet_v2,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)
