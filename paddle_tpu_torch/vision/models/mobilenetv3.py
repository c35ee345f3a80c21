"""MobileNetV3 (reference: python/paddle/vision/models/mobilenetv3.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, Hardswish,
                   Hardsigmoid, Linear, Dropout, AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten
from ._utils import _make_divisible, load_pretrained

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


class SqueezeExcitation(Layer):
    """reference: mobilenetv3.py:38."""

    def __init__(self, channels, squeeze_channels):
        super().__init__()
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(channels, squeeze_channels, 1)
        self.fc2 = Conv2D(squeeze_channels, channels, 1)
        self.relu = ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.avgpool(x)
        s = self.relu(self.fc1(s))
        s = self.hsig(self.fc2(s))
        return x * s


def _conv_bn_act(in_c, out_c, kernel, stride=1, groups=1, act=None):
    layers = [Conv2D(in_c, out_c, kernel, stride=stride,
                     padding=(kernel - 1) // 2, groups=groups,
                     bias_attr=False),
              BatchNorm2D(out_c)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class InvertedResidual(Layer):
    """reference: mobilenetv3.py:115."""

    def __init__(self, in_c, expanded, out_c, kernel, stride, use_se,
                 use_hs):
        super().__init__()
        act = Hardswish if use_hs else ReLU
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expanded != in_c:
            layers.append(_conv_bn_act(in_c, expanded, 1, act=act))
        layers.append(_conv_bn_act(expanded, expanded, kernel, stride,
                                   groups=expanded, act=act))
        if use_se:
            layers.append(SqueezeExcitation(
                expanded, _make_divisible(expanded // 4)))
        layers.append(_conv_bn_act(expanded, out_c, 1, act=None))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(Layer):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = lambda ch: _make_divisible(ch * scale)  # noqa: E731
        in_c = c(16)
        blocks = [_conv_bn_act(3, in_c, 3, stride=2, act=Hardswish)]
        for k, exp, out, se, hs, s in cfg:
            blocks.append(InvertedResidual(in_c, c(exp), c(out), k, s,
                                           se, hs))
            in_c = c(out)
        last_conv = 6 * in_c
        blocks.append(_conv_bn_act(in_c, last_conv, 1, act=Hardswish))
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_conv, last_channel), Hardswish(),
                Dropout(0.2), Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


# (kernel, expanded, out, use_se, use_hs, stride)
_SMALL = [
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]
_LARGE = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, last_channel=1024, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, last_channel=1280, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(MobileNetV3Small(scale=scale, **kwargs),
                           f"mobilenet_v3_small_x{float(scale)}", pretrained)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(MobileNetV3Large(scale=scale, **kwargs),
                           f"mobilenet_v3_large_x{float(scale)}", pretrained)
