"""Fake-quantization primitives with straight-through gradients (the port
of ``paddle_tpu/quantization/functional.py``).

Reference analog: the fake_quantize_* / fake_channel_wise_quantize ops
(paddle/fluid/operators/fake_quantize_op.cc) that back
FakeQuanterWithAbsMaxObserverLayer.

Fake quant-dequant is an elementwise ``torch.autograd.Function`` with the
saturating straight-through estimator: the gradient passes where
``|x| <= max(scale, 1e-9)`` and is zero outside; ``scale`` gets none.
The forward runs ``clip(round(x / s * qmax))`` in the reference's
operation order (``torch.round`` rounds half to even, as ``jnp.round``
does), so float32 outputs equal the reference's bit for bit.  Mixed
input dtypes promote as JAX promotes them (bf16 with f32 is f32).
"""
from __future__ import annotations

import torch

__all__ = ["fake_quant_dequant", "quant_tensor", "dequant_tensor"]


class _FQD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = torch.clamp_min(scale, 1e-9)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        ctx.save_for_backward(x, scale)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inside = (x.abs() <= torch.clamp_min(scale, 1e-9)).to(g.dtype)
        return g * inside, None, None


def _promote(x, scale):
    scale = torch.as_tensor(scale, device=x.device)
    if not scale.is_floating_point():
        scale = scale.float()
    dt = torch.promote_types(x.dtype, scale.dtype)
    return x.to(dt), scale.to(dt)


def fake_quant_dequant(x, scale, bits=8, quant_axis=None):
    """Quantize-dequantize ``x`` symmetrically to ``bits`` with the
    saturating STE.  ``scale`` is the absmax (a scalar, or per channel
    along ``quant_axis``)."""
    qmax = float(2 ** (bits - 1) - 1)
    x, scale = _promote(x, scale)
    if quant_axis is not None and scale.dim() > 0:
        shape = [1] * x.dim()
        shape[quant_axis] = -1
        scale = scale.reshape(shape)
    return _FQD.apply(x, scale, qmax)


def quant_tensor(x, scale, bits=8):
    """True quantization to int (for export); no gradient."""
    qmax = 2 ** (bits - 1) - 1
    x, scale = _promote(x.detach(), scale)
    s = torch.clamp_min(scale, 1e-9)
    out_dtype = torch.int8 if bits <= 8 else \
        torch.int16 if bits <= 16 else torch.int32
    return torch.clamp(torch.round(x / s * qmax), -qmax, qmax).to(out_dtype)


def dequant_tensor(q, scale, bits=8, dtype=torch.float32):
    qmax = 2 ** (bits - 1) - 1
    return q.to(dtype) * (scale / qmax)
