"""Inception v3 (reference: python/paddle/vision/models/inceptionv3.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                   AvgPool2D, Dropout, Linear, AdaptiveAvgPool2D)
from ...tensor.manipulation import concat, flatten
from ._utils import load_pretrained

__all__ = ["InceptionV3", "inception_v3"]


def _conv_bn(in_c, out_c, kernel, stride=1, padding=0):
    return Sequential(
        Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
               bias_attr=False),
        BatchNorm2D(out_c), ReLU())


class InceptionA(Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = _conv_bn(in_c, 64, 1)
        self.b5 = Sequential(_conv_bn(in_c, 48, 1),
                             _conv_bn(48, 64, 5, padding=2))
        self.b3 = Sequential(_conv_bn(in_c, 64, 1),
                             _conv_bn(64, 96, 3, padding=1),
                             _conv_bn(96, 96, 3, padding=1))
        self.bp = Sequential(AvgPool2D(3, 1, 1),
                             _conv_bn(in_c, pool_features, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class InceptionB(Layer):  # grid reduction 35→17
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _conv_bn(in_c, 384, 3, stride=2)
        self.b3d = Sequential(_conv_bn(in_c, 64, 1),
                              _conv_bn(64, 96, 3, padding=1),
                              _conv_bn(96, 96, 3, stride=2))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class InceptionC(Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _conv_bn(in_c, 192, 1)
        self.b7 = Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, 1, 1), _conv_bn(in_c, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], 1)


class InceptionD(Layer):  # grid reduction 17→8
    def __init__(self, in_c):
        super().__init__()
        self.b3 = Sequential(_conv_bn(in_c, 192, 1),
                             _conv_bn(192, 320, 3, stride=2))
        self.b7 = Sequential(
            _conv_bn(in_c, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], 1)


class InceptionE(Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _conv_bn(in_c, 320, 1)
        self.b3_stem = _conv_bn(in_c, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = Sequential(_conv_bn(in_c, 448, 1),
                                   _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, 1, 1), _conv_bn(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return concat([self.b1(x),
                       concat([self.b3_a(s), self.b3_b(s)], 1),
                       concat([self.b3d_a(d), self.b3d_b(d)], 1),
                       self.bp(x)], 1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _conv_bn(3, 32, 3, stride=2), _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1), MaxPool2D(3, 2),
            _conv_bn(64, 80, 1), _conv_bn(80, 192, 3), MaxPool2D(3, 2))
        self.blocks = Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160),
            InceptionC(768, 160), InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return load_pretrained(InceptionV3(**kwargs), "inception_v3",
                           pretrained)
