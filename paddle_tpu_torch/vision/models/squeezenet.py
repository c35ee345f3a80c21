"""SqueezeNet (reference: python/paddle/vision/models/squeezenet.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, ReLU, MaxPool2D, Dropout,
                   AdaptiveAvgPool2D)
from ...tensor.manipulation import concat, flatten
from ._utils import load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(Layer):
    def __init__(self, in_c, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = Conv2D(in_c, squeeze, 1)
        self.expand1x1 = Conv2D(squeeze, expand1x1, 1)
        self.expand3x3 = Conv2D(squeeze, expand3x3, 3, padding=1)
        self.relu = ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1x1(x)),
                       self.relu(self.expand3x3(x))], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(), MaxPool2D(3, 2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128), MaxPool2D(3, 2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                MaxPool2D(3, 2), Fire(512, 64, 256, 256),
            )
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2), ReLU(), MaxPool2D(3, 2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                MaxPool2D(3, 2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                MaxPool2D(3, 2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1), ReLU())
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return flatten(x, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    return load_pretrained(SqueezeNet("1.0", **kwargs), "squeezenet1_0",
                           pretrained)


def squeezenet1_1(pretrained=False, **kwargs):
    return load_pretrained(SqueezeNet("1.1", **kwargs), "squeezenet1_1",
                           pretrained)
