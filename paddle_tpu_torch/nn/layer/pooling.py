"""Pooling layers (the port of ``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from .layers import Layer
from .. import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw


class MaxPool1D(_PoolNd):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("ceil_mode", "data_format")})


class MaxPool2D(_PoolNd):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("ceil_mode", "data_format")})


class MaxPool3D(_PoolNd):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("ceil_mode", "data_format")})


class AvgPool1D(_PoolNd):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("exclusive", "ceil_mode",
                                        "data_format")})


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("exclusive", "ceil_mode",
                                        "data_format")})


class AvgPool3D(_PoolNd):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **{k: v for k, v in self.kw.items()
                               if k in ("exclusive", "ceil_mode",
                                        "data_format")})


class _AdaptivePoolNd(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.kw.get("data_format", "NCHW"))


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.kw.get("data_format", "NCDHW"))


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format,
                      output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool1d(x, indices, k, s, p, df, osz)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format,
                      output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool2d(x, indices, k, s, p, df, osz)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format,
                      output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool3d(x, indices, k, s, p, df, osz)


__all__ += ["MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]
