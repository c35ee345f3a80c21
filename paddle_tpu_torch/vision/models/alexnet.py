"""AlexNet (reference: python/paddle/vision/models/alexnet.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, ReLU, MaxPool2D, Dropout,
                   Linear, AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten
from ._utils import load_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, 2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Linear(256 * 6 * 6, 4096), ReLU(),
                Dropout(0.5), Linear(4096, 4096), ReLU(),
                Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    return load_pretrained(AlexNet(**kwargs), "alexnet", pretrained)
