"""nn.utils: parameter flattening and the weight-norm and spectral-norm
wrappers (the port of ``paddle_tpu/nn/utils/__init__.py``).

``weight_norm``'s weight is computed from ``g`` and ``v`` by ops, so
the gradient reaches both; the reference builds it from their arrays,
which leaves them without one.
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor, apply_op
from ..layer.layers import Parameter

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm"]


def parameters_to_vector(parameters, name=None):
    return apply_op(lambda *ts: torch.cat([t.reshape(-1) for t in ts]),
                    *parameters, op_name="parameters_to_vector")


def vector_to_parameters(vec, parameters, name=None):
    t = vec._t if isinstance(vec, Tensor) else torch.as_tensor(vec)
    offset = 0
    for p in parameters:
        n = p._t.numel()
        p._set_array(t[offset:offset + n].reshape(p._t.shape))
        offset += n


def _norm_except(t, dim):
    if dim is None:
        return torch.linalg.vector_norm(t)
    axes = tuple(i for i in range(t.dim()) if i != dim)
    return torch.sqrt(torch.sum(t * t, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize weight = g * v / ||v|| by a forward-pre-hook."""
    w = getattr(layer, name)._t.detach()
    layer.add_parameter(name + "_g", Parameter(_norm_except(w, dim)))
    layer.add_parameter(name + "_v", Parameter(w.clone()))
    del layer._parameters[name]

    def compute(lyr):
        w_t = apply_op(
            lambda g, v: g * v / torch.clamp(_norm_except(v, dim), min=1e-12),
            getattr(lyr, name + "_g"), getattr(lyr, name + "_v"),
            op_name="weight_norm")
        object.__setattr__(lyr, name, w_t)

    def hook(lyr, inputs):
        compute(lyr)
        return None
    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_name = name
    compute(layer)
    return layer


def remove_weight_norm(layer, name="weight"):
    if hasattr(layer, "_weight_norm_handle"):
        layer._weight_norm_handle.remove()
    layer._parameters.pop(name + "_g", None)
    v = layer._parameters.pop(name + "_v", None)
    if v is not None:
        w = getattr(layer, name)
        layer.add_parameter(name, Parameter(
            (w if isinstance(w, Tensor) else v)._t.detach()))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    from ..layer.norm import SpectralNorm as _SN
    weight = getattr(layer, name)
    sn = _SN(weight.shape, dim=0 if dim is None else dim,
             power_iters=n_power_iterations, eps=eps)
    layer.add_sublayer(name + "_sn", sn)
    layer.add_parameter(name + "_orig", Parameter(weight._t.detach()))
    del layer._parameters[name]

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, sn(getattr(lyr, name + "_orig")))
        return None
    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer
