"""DenseNet family (reference: python/paddle/vision/models/densenet.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                   AvgPool2D, Linear, AdaptiveAvgPool2D, Dropout)
from ...tensor.manipulation import concat, flatten
from ._utils import load_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.norm1 = BatchNorm2D(in_c)
        self.conv1 = Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False)
        self.norm2 = BatchNorm2D(bn_size * growth_rate)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias_attr=False)
        self.relu = ReLU()
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _Transition(Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.norm = BatchNorm2D(in_c)
        self.relu = ReLU()
        self.conv = Conv2D(in_c, out_c, 1, bias_attr=False)
        self.pool = AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        assert layers in _CFGS, f"supported layers: {sorted(_CFGS)}"
        num_init, growth, block_cfg = _CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            BatchNorm2D(num_init), ReLU(), MaxPool2D(3, 2, 1))
        blocks = []
        ch = num_init
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if i != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2))
                ch //= 2
        self.blocks = Sequential(*blocks)
        self.norm_final = BatchNorm2D(ch)
        self.relu = ReLU()
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(ch, num_classes)

    def forward(self, x):
        x = self.relu(self.norm_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    return load_pretrained(DenseNet(layers=layers, **kwargs),
                           f"densenet{layers}", pretrained)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
