"""The vision model zoo (port of ``paddle_tpu/vision/models/``)."""
from .lenet import LeNet  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
