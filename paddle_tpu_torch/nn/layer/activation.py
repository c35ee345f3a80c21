"""Activation layers, thin wrappers over the functionals (the port of
``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from .layers import Layer
from .. import functional as F
from .. import initializer as I

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
           "GELU", "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid",
           "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "Softplus",
           "Softsign", "Sigmoid", "LogSigmoid", "Tanh", "Softmax",
           "LogSoftmax", "Maxout", "GLU", "RReLU", "ThresholdedReLU"]


def _simple(fname, **fixed):
    class _Act(Layer):
        def __init__(self, name=None, **kw):
            super().__init__()
            self._kw = {**fixed, **kw}

        def forward(self, x):
            return getattr(F, fname)(x, **self._kw)
    return _Act


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


Swish = Silu


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)


class RReLU(Layer):
    def __init__(self, lower=1 / 8.0, upper=1 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class Softmax2D(Layer):
    """reference: nn/layer/activation.py Softmax2D — softmax over the
    channel dim of NCHW (per spatial position)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects a 3-D or 4-D input, got {x.ndim}-D")
        return F.softmax(x, axis=-3)


__all__ += ["Softmax2D"]
