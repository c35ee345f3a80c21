"""LeNet (reference: python/paddle/vision/models/lenet.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, ReLU, MaxPool2D, Linear)


class LeNet(Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0),
            ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120),
                Linear(120, 84),
                Linear(84, num_classes))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten
            x = flatten(x, 1)
            x = self.fc(x)
        return x
