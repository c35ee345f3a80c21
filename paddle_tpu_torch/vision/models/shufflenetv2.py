"""ShuffleNetV2 (reference: python/paddle/vision/models/shufflenetv2.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, Swish,
                   MaxPool2D, Linear, AdaptiveAvgPool2D, ChannelShuffle)
from ...tensor.manipulation import concat, flatten, split
from ._utils import load_pretrained

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}
_STAGE_REPEATS = [4, 8, 4]


def _conv_bn(in_c, out_c, kernel, stride=1, groups=1, act=ReLU):
    layers = [Conv2D(in_c, out_c, kernel, stride=stride,
                     padding=kernel // 2, groups=groups, bias_attr=False),
              BatchNorm2D(out_c)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class InvertedResidual(Layer):
    """Stride-1 unit: split channels, transform one half, shuffle."""

    def __init__(self, channels, act):
        super().__init__()
        half = channels // 2
        self.branch = Sequential(
            _conv_bn(half, half, 1, act=act),
            _conv_bn(half, half, 3, groups=half, act=None),
            _conv_bn(half, half, 1, act=act))
        self.shuffle = ChannelShuffle(2)

    def forward(self, x):
        x1, x2 = split(x, 2, axis=1)
        return self.shuffle(concat([x1, self.branch(x2)], axis=1))


class InvertedResidualDS(Layer):
    """Stride-2 (downsampling) unit: both branches transform, no split."""

    def __init__(self, in_c, out_c, act):
        super().__init__()
        half = out_c // 2
        self.branch1 = Sequential(
            _conv_bn(in_c, in_c, 3, stride=2, groups=in_c, act=None),
            _conv_bn(in_c, half, 1, act=act))
        self.branch2 = Sequential(
            _conv_bn(in_c, half, 1, act=act),
            _conv_bn(half, half, 3, stride=2, groups=half, act=None),
            _conv_bn(half, half, 1, act=act))
        self.shuffle = ChannelShuffle(2)

    def forward(self, x):
        return self.shuffle(concat([self.branch1(x), self.branch2(x)],
                                   axis=1))


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        act_layer = Swish if act == "swish" else ReLU
        outs = _STAGE_OUT[scale]
        self.conv1 = _conv_bn(3, outs[0], 3, stride=2, act=act_layer)
        self.maxpool = MaxPool2D(3, 2, 1)
        blocks = []
        in_c = outs[0]
        for stage, repeats in enumerate(_STAGE_REPEATS):
            out_c = outs[stage + 1]
            blocks.append(InvertedResidualDS(in_c, out_c, act_layer))
            for _ in range(repeats - 1):
                blocks.append(InvertedResidual(out_c, act_layer))
            in_c = out_c
        self.blocks = Sequential(*blocks)
        self.conv_last = _conv_bn(in_c, outs[-1], 1, act=act_layer)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(outs[-1], num_classes)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=0.25, **kwargs),
                           "shufflenet_v2_x0_25", pretrained)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=0.33, **kwargs),
                           "shufflenet_v2_x0_33", pretrained)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=0.5, **kwargs),
                           "shufflenet_v2_x0_5", pretrained)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=1.0, **kwargs),
                           "shufflenet_v2_x1_0", pretrained)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=1.5, **kwargs),
                           "shufflenet_v2_x1_5", pretrained)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=2.0, **kwargs),
                           "shufflenet_v2_x2_0", pretrained)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return load_pretrained(ShuffleNetV2(scale=1.0, act="swish", **kwargs),
                           "shufflenet_v2_swish", pretrained)
