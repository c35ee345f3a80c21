"""Weight initializers (the port of
``paddle_tpu/nn/initializer/__init__.py``): each is a function
``(shape, dtype) -> torch tensor`` on the current place, drawn in float32
from the global generator and cast."""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ...core.place import current_device
from ...framework.random import generator_for

__all__ = [
    "Bilinear",
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain", "set_global_initializer",
]

_GLOBAL = {"weight": None, "bias": None}


def _normal(shape):
    dev = current_device()
    return torch.randn(tuple(shape), generator=generator_for(dev),
                       dtype=torch.float32, device=dev)


def _uniform(shape, low, high):
    dev = current_device()
    u = torch.rand(tuple(shape), generator=generator_for(dev),
                   dtype=torch.float32, device=dev)
    return u * (high - low) + low


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return (_normal(shape) * self.std + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """The normal law cut to [a, b] standard deviations, by the inverse
    CDF of a uniform draw between the bounds' CDFs."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        cdf = lambda v: 0.5 * (1 + _math.erf(v / _math.sqrt(2)))  # noqa: E731
        u = _uniform(shape, cdf(self.a), cdf(self.b))
        z = _math.sqrt(2) * torch.erfinv(2 * u - 1)
        z = z.clamp(self.a, self.b)
        return (z * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, self.low, self.high).to(dtype)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        # paddle convention: Linear weights are [in, out], conv weights
        # [out_c, in_c, *k]
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        else:
            fan_in = shape[1] * receptive
            fan_out = shape[0] * receptive
    return fan_in, fan_out


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * _math.sqrt(2.0 / (fi + fo))
        return (_normal(shape) * std).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * _math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return (_normal(shape) * (gain / _math.sqrt(fi))).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * _math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from ...core.tensor import Tensor, _as_torch
        v = self.value
        v = v._t.detach() if isinstance(v, Tensor) else v
        t = _as_torch(v, dtype, current_device()).clone()
        assert tuple(t.shape) == tuple(shape), \
            f"Assign initializer shape mismatch {tuple(t.shape)} vs {shape}"
        return t


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over the last axis, from the QR of a
    normal draw with R's diagonal signs folded in (``jax.nn.initializers
    .orthogonal``'s construction)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        q, r = torch.linalg.qr(_normal(mshape))
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out_c, in_c = shape[0], shape[1]
        arr = np.zeros(shape, dtype=np.float32)
        centers = [k // 2 for k in shape[2:]]
        per = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per, in_c)):
                idx = (g * per + i, i) + tuple(centers)
                arr[idx] = 1.0
        return torch.from_numpy(arr).to(device=current_device(), dtype=dtype)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return _math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        slope = param if param is not None else 0.01
        return _math.sqrt(2.0 / (1 + slope ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unsupported nonlinearity {nonlinearity}")


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL["weight"] = weight_init
    _GLOBAL["bias"] = bias_init


def _resolve_initializer(attr, default_initializer=None, is_bias=False):
    """ParamAttr / initializer resolution."""
    from ...framework.param_attr import ParamAttr
    if isinstance(attr, Initializer):
        return attr
    if isinstance(attr, ParamAttr) and attr.initializer is not None:
        return attr.initializer
    if default_initializer is not None:
        return default_initializer
    g = _GLOBAL["bias" if is_bias else "weight"]
    if g is not None:
        return g
    return Constant(0.0) if is_bias else XavierUniform()


class Bilinear(Initializer):
    """The bilinear-upsampling kernel for transposed-conv weights
    [C_out, C_in, K, K]: every (out, in) filter gets it."""

    def __call__(self, shape, dtype):
        assert len(shape) == 4, "Bilinear expects a 4-D conv weight"
        k = shape[-1]
        assert shape[-2] == k, "Bilinear expects square kernels"
        # f = ceil(k/2), c = (2f - 1 - f%2) / (2f), w[i] = 1 - |i/f - c|
        f = (k + 1) // 2
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = torch.arange(k, dtype=torch.float32, device=current_device())
        filt = 1.0 - torch.abs(og / f - c)
        kernel2d = filt[:, None] * filt[None, :]
        return torch.broadcast_to(kernel2d, tuple(shape)).to(dtype).clone()
