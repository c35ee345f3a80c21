"""GoogLeNet / Inception v1 (reference:
python/paddle/vision/models/googlenet.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, ReLU, MaxPool2D,
                   Dropout, Linear, AdaptiveAvgPool2D)
from ...tensor.manipulation import concat, flatten
from ._utils import load_pretrained

__all__ = ["GoogLeNet", "googlenet"]


def _conv_relu(in_c, out_c, kernel, stride=1, padding=0):
    return Sequential(Conv2D(in_c, out_c, kernel, stride=stride,
                             padding=padding), ReLU())


class Inception(Layer):
    """reference: googlenet.py:67."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.branch1 = _conv_relu(in_c, c1, 1)
        self.branch2 = Sequential(_conv_relu(in_c, c3r, 1),
                                  _conv_relu(c3r, c3, 3, padding=1))
        self.branch3 = Sequential(_conv_relu(in_c, c5r, 1),
                                  _conv_relu(c5r, c5, 5, padding=2))
        self.branch4 = Sequential(MaxPool2D(3, 1, 1),
                                  _conv_relu(in_c, proj, 1))

    def forward(self, x):
        return concat([self.branch1(x), self.branch2(x), self.branch3(x),
                       self.branch4(x)], axis=1)


class GoogLeNet(Layer):
    """Returns (out, aux1, aux2) like the reference (googlenet.py:107)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_relu(3, 64, 7, stride=2, padding=3), MaxPool2D(3, 2, 1),
            _conv_relu(64, 64, 1), _conv_relu(64, 192, 3, padding=1),
            MaxPool2D(3, 2, 1))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2D(3, 2, 1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2D(3, 2, 1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.4)
            self.fc = Linear(1024, num_classes)
            # auxiliary classifiers off inc4a / inc4d; adaptive pooling to
            # the reference's 4x4 aux grid keeps them input-size agnostic
            self.aux_pool1 = AdaptiveAvgPool2D((4, 4))
            self.aux_conv1 = _conv_relu(512, 128, 1)
            self.aux_fc1 = Sequential(Linear(128 * 4 * 4, 1024), ReLU(),
                                      Dropout(0.7), Linear(1024,
                                                           num_classes))
            self.aux_pool2 = AdaptiveAvgPool2D((4, 4))
            self.aux_conv2 = _conv_relu(528, 128, 1)
            self.aux_fc2 = Sequential(Linear(128 * 4 * 4, 1024), ReLU(),
                                      Dropout(0.7), Linear(1024,
                                                           num_classes))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        a = self.inc4a(x)
        x = self.inc4c(self.inc4b(a))
        d = self.inc4d(x)
        x = self.pool4(self.inc4e(d))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            out = self.fc(self.dropout(flatten(x, 1)))
            aux1 = self.aux_fc1(flatten(self.aux_conv1(self.aux_pool1(a)),
                                        1))
            aux2 = self.aux_fc2(flatten(self.aux_conv2(self.aux_pool2(d)),
                                        1))
            return out, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    return load_pretrained(GoogLeNet(**kwargs), "googlenet", pretrained)
