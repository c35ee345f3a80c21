"""VGG family (reference: python/paddle/vision/models/vgg.py)."""
from __future__ import annotations

from ...nn import (Layer, Sequential, Conv2D, BatchNorm2D, ReLU, MaxPool2D,
                   Dropout, Linear, AdaptiveAvgPool2D)
from ...tensor.manipulation import flatten
from ._utils import load_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False):
    layers, in_c = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                Linear(4096, 4096), ReLU(), Dropout(),
                Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(arch, cfg, batch_norm, pretrained, **kwargs):
    model = VGG(_make_features(_CFGS[cfg], batch_norm), **kwargs)
    return load_pretrained(model, arch + ("_bn" if batch_norm else ""),
                           pretrained)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
