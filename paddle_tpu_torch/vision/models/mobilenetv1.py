"""MobileNetV1 (reference: python/paddle/vision/models/mobilenetv1.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, Linear,
                   AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten
from ._utils import _make_divisible, load_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


def _conv_bn(in_c, out_c, kernel, stride=1, padding=0, groups=1):
    return Sequential(
        Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
               groups=groups, bias_attr=False),
        BatchNorm2D(out_c), ReLU())


class DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.depthwise = _conv_bn(in_c, in_c, 3, stride, 1, groups=in_c)
        self.pointwise = _conv_bn(in_c, out_c, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = lambda ch: _make_divisible(ch * scale)  # noqa: E731
        cfg = [  # (in, out, stride)
            (c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
            (c(128), c(256), 2), (c(256), c(256), 1), (c(256), c(512), 2),
            (c(512), c(512), 1), (c(512), c(512), 1), (c(512), c(512), 1),
            (c(512), c(512), 1), (c(512), c(512), 1), (c(512), c(1024), 2),
            (c(1024), c(1024), 1),
        ]
        blocks = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
        blocks += [DepthwiseSeparable(i, o, s) for i, o, s in cfg]
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(MobileNetV1(scale=scale, **kwargs),
                           f"mobilenetv1_{float(scale)}", pretrained)
