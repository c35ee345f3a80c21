"""Norm layers: BatchNorm, LayerNorm, RMSNorm, GroupNorm, InstanceNorm,
LocalResponseNorm, SpectralNorm (the port of
``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch

from .layers import Layer
from .. import functional as F
from .. import initializer as I
from ...core.place import current_device
from ...core.tensor import Tensor, apply_op

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        dev = current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            [num_features], dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            [num_features], dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCDHW"
                         else data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over one process's batch (the cross-replica
    statistics come with the eager distributed API);
    ``convert_sync_batchnorm`` mirrors the reference API."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """Spectral normalization via power iteration
    (reference: nn/layer/norm.py SpectralNorm over spectral_norm op)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0, 1))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0, 1))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        u0, v0 = self.weight_u._t.detach(), self.weight_v._t.detach()
        dim, power_iters, eps = self._dim, self._power_iters, self._eps

        def _f(w):
            wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
            # the power iteration refines the persistent u/v estimate;
            # gradients do not flow through it (u and v are buffers)
            u, v = u0, v0
            wd = wm.detach()
            for _ in range(power_iters):
                v = wd.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wd @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = u @ wm @ v
            return w / sigma, u, v
        out, u_new, v_new = apply_op(_f, weight, op_name="spectral_norm")
        # keep the refined vectors so sigma converges across forwards
        self.weight_u._set_array(u_new._t)
        self.weight_v._set_array(v_new._t)
        return out
