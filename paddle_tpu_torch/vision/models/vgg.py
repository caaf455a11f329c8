"""VGG family (port of ``paddle_tpu/vision/models/vgg.py``)."""
from ... import nn

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        if num_classes > 0:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.avgpool(x)
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, **kwargs):
    return VGG(make_layers(_CFGS[cfg], batch_norm=batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
