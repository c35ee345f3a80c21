"""Activation functionals (the port of
``paddle_tpu/nn/functional/activation.py``), each the reference's
composition in torch ops."""
from __future__ import annotations

import torch

from ...core.tensor import apply_op, rebind_inplace, tape_snapshot
from ...ops.registry import register, _ensure_tensor

__all__ = [
    "relu", "relu_", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
    "gelu", "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "softplus", "softsign",
    "sigmoid", "log_sigmoid", "tanh", "softmax", "log_softmax", "gumbel_softmax",
    "maxout", "glu", "rrelu", "thresholded_relu",
]


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def relu(x, name=None):
    return apply_op(torch.relu, _ensure_tensor(x), op_name="relu")


def relu_(x):
    return rebind_inplace(x, relu(tape_snapshot(x)))


def relu6(x, name=None):
    return apply_op(lambda a: torch.clamp(a, 0, 6), _ensure_tensor(x),
                    op_name="relu6")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda a: torch.where(a >= 0, a, negative_slope * a),
                    _ensure_tensor(x), op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = _ensure_tensor(x), _ensure_tensor(weight)

    def _f(a, w):
        if w.numel() > 1:
            ch_axis = 1 if data_format[1] == "C" else a.dim() - 1
            shape = [1] * a.dim()
            shape[ch_axis] = w.numel()
            w = w.reshape(shape)
        return torch.where(a >= 0, a, w * a)
    return apply_op(_f, x, weight, op_name="prelu")


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda a: torch.where(a > 0, a,
                                          alpha * (torch.exp(a) - 1)),
                    _ensure_tensor(x), op_name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(
        lambda a: scale * torch.where(a > 0, a, alpha * (torch.exp(a) - 1)),
        _ensure_tensor(x), op_name="selu")


def celu(x, alpha=1.0, name=None):
    return apply_op(
        lambda a: torch.clamp(a, min=0) + torch.clamp(
            alpha * (torch.exp(a / alpha) - 1), max=0),
        _ensure_tensor(x), op_name="celu")


def gelu(x, approximate=False, name=None):
    return apply_op(lambda a: torch.nn.functional.gelu(
        a, approximate="tanh" if approximate else "none"),
        _ensure_tensor(x), op_name="gelu")


def silu(x, name=None):
    return apply_op(lambda a: a * torch.sigmoid(a), _ensure_tensor(x),
                    op_name="silu")


def swish(x, name=None):
    return silu(x)


def _softplus(a):
    return torch.logaddexp(a, _zero(a))


def mish(x, name=None):
    return apply_op(lambda a: a * torch.tanh(_softplus(a)),
                    _ensure_tensor(x), op_name="mish")


def hardswish(x, name=None):
    return apply_op(lambda a: a * torch.clamp(a + 3, 0, 6) / 6,
                    _ensure_tensor(x), op_name="hardswish")


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return apply_op(lambda a: torch.clamp(slope * a + offset, 0, 1),
                    _ensure_tensor(x), op_name="hardsigmoid")


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return apply_op(lambda a: torch.clamp(a, min, max), _ensure_tensor(x),
                    op_name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(
        lambda a: torch.where(torch.abs(a) > threshold, a, _zero(a)),
        _ensure_tensor(x), op_name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply_op(
        lambda a: torch.where(a > threshold, a - threshold,
                              torch.where(a < -threshold, a + threshold,
                                          _zero(a))),
        _ensure_tensor(x), op_name="softshrink")


def tanhshrink(x, name=None):
    return apply_op(lambda a: a - torch.tanh(a), _ensure_tensor(x),
                    op_name="tanhshrink")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op(
        lambda a: torch.where(beta * a > threshold, a,
                              torch.log1p(torch.exp(beta * a)) / beta),
        _ensure_tensor(x), op_name="softplus")


def softsign(x, name=None):
    return apply_op(lambda a: a / (1 + torch.abs(a)), _ensure_tensor(x),
                    op_name="softsign")


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, _ensure_tensor(x), op_name="sigmoid")


def log_sigmoid(x, name=None):
    return apply_op(lambda a: -_softplus(-a), _ensure_tensor(x),
                    op_name="log_sigmoid")


def tanh(x, name=None):
    return apply_op(torch.tanh, _ensure_tensor(x), op_name="tanh")


def _cast(a, dtype):
    if dtype is None:
        return a
    from ...core import dtype as dtype_mod
    return a.to(dtype_mod.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.softmax(_cast(a, dtype), axis), x,
                    op_name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.log_softmax(_cast(a, dtype), axis), x,
                    op_name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    from ...framework.random import generator_for
    x = _ensure_tensor(x)
    a0 = x._t
    tiny = torch.finfo(a0.dtype).tiny
    u = torch.rand(a0.shape, generator=generator_for(a0.device),
                   dtype=a0.dtype, device=a0.device).clamp(min=tiny)
    g = -torch.log(-torch.log(u))

    def _f(a):
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            idx = torch.argmax(y, axis, keepdim=True)
            onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = onehot + y - y.detach()
        return y
    return apply_op(_f, x, op_name="gumbel_softmax")


def maxout(x, groups, axis=1, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        new_shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(new_shape), dim=ax + 1)
    return apply_op(_f, x, op_name="maxout")


def glu(x, axis=-1, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        a1, a2 = torch.chunk(a, 2, axis)
        return a1 * torch.sigmoid(a2)
    return apply_op(_f, x, op_name="glu")


def rrelu(x, lower=1 / 8.0, upper=1 / 3.0, training=True, name=None):
    from ...framework.random import generator_for
    x = _ensure_tensor(x)
    if training:
        a0 = x._t
        slope = torch.rand(a0.shape, generator=generator_for(a0.device),
                           dtype=a0.dtype, device=a0.device) \
            * (upper - lower) + lower
        return apply_op(lambda a: torch.where(a >= 0, a, slope * a), x,
                        op_name="rrelu")
    return leaky_relu(x, (lower + upper) / 2)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op(lambda a: torch.where(
        a > threshold, a, torch.full_like(a, value)),
        _ensure_tensor(x), op_name="thresholded_relu")


for _n in __all__:
    if not _n.endswith("_"):
        register(_n, globals()[_n])
