"""MobileNetV2 (reference: python/paddle/vision/models/mobilenetv2.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU6, Linear,
                   Dropout, AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten
from ._utils import _make_divisible, load_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _conv_bn_relu6(in_c, out_c, kernel=3, stride=1, groups=1):
    return Sequential(
        Conv2D(in_c, out_c, kernel, stride=stride,
               padding=(kernel - 1) // 2, groups=groups, bias_attr=False),
        BatchNorm2D(out_c), ReLU6())


class InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn_relu6(in_c, hidden, 1))
        layers += [
            _conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
            Conv2D(hidden, out_c, 1, bias_attr=False),
            BatchNorm2D(out_c),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        blocks = [_conv_bn_relu6(3, in_c, 3, stride=2)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(in_c, out_c,
                                               s if i == 0 else 1, t))
                in_c = out_c
        blocks.append(_conv_bn_relu6(in_c, last_c, 1))
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2),
                                         Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(MobileNetV2(scale=scale, **kwargs),
                           f"mobilenetv2_{float(scale)}", pretrained)
