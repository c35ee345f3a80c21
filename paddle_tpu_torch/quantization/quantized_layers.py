"""Int8 inference layers — the deploy form of QAT/PTQ-calibrated models
(the port of ``paddle_tpu/quantization/quantized_layers.py``).

Reference analog: the QuantizationFreezePass + AddQuantDequantPass
product (static/quantization/quantization_pass.py:103,1827): ops in the
served program consume int8-quantized activations against int8 weights,
with calibrated (PTQ) or trained (QAT) scales baked in.

``quantization.convert(model, to_int8=True)`` replaces each calibrated
QuantedWrapper with one of these layers; the model then exports through
``jit.save`` and serves on the Python Predictor and the C ABI unchanged.

- ``QuantizedLinear`` computes in real int8: the activation quantizes
  at the calibrated scale, the int8 x int8 product accumulates exactly
  in int32, and one rescale dequantizes the result.  The product is not
  a kernel of the reference (it is ``lax.dot_general`` outside any
  Pallas call), so the port takes a library product, chosen by shape
  only: on the card ``torch._int_mm`` where its rules hold (M > 16, K
  and N multiples of 8), else a float64 product, exact while
  127 * 127 * K < 2**53; on the CPU an int32 product.  Every route
  gives the same int32 accumulator.
- ``QuantizedConv2D`` stores int8 weights and quant-dequants the
  activation at its calibrated scale (the AddQuantDequantPass form);
  the convolution runs in float after the weight is dequantized.  The
  float weight is dropped, so the saved state carries int8 only.

Scale convention matches quantization.functional: ``scale`` is the
observed absmax; q = round(x / scale * qmax), x ~ q * scale / qmax.
Buffer names are the reference's (``qweight``, ``w_scale``,
``act_scale``, ``bias``), so a reference layer's ``state_dict()``
crosses as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import current_device
from ..core.tensor import Tensor, apply_op
from ..nn.layer.layers import Layer

__all__ = ["QuantizedLinear", "QuantizedConv2D", "int8_product"]


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _buffer(value, dtype):
    """A buffer Tensor of ``dtype`` from a Tensor, a torch tensor (kept
    on its device) or an array (on the current place)."""
    if isinstance(value, Tensor):
        value = value._t
    if torch.is_tensor(value):
        return Tensor._wrap(value.detach().to(dtype).clone())
    return Tensor._wrap(torch.as_tensor(np.asarray(value)).to(
        dtype=dtype, device=current_device()))


def int8_product(xq: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The int32 accumulator of ``xq`` [M, K] int8 @ ``qw`` [K, N] int8,
    exact on every route (see the module docstring)."""
    M, K = xq.shape
    N = qw.shape[1]
    if not xq.is_cuda:
        return xq.to(torch.int32) @ qw.to(torch.int32)
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm(xq.contiguous(), qw.contiguous())
    return (xq.double() @ qw.double()).to(torch.int32)


class QuantizedLinear(Layer):
    """y = dequant(int8(x) @ int8(W)) + b with per-out-channel weight
    scales (weight layout [in, out], scale shape [out] or scalar)."""

    def __init__(self, qweight, w_scale, act_scale, bias=None, bits=8):
        super().__init__()
        self._bits = int(bits)
        self.register_buffer("qweight", _buffer(qweight, torch.int8))
        self.register_buffer("w_scale", _buffer(w_scale, torch.float32))
        self.register_buffer("act_scale",
                             _buffer(act_scale, torch.float32))
        if bias is not None:
            self.register_buffer("bias", _buffer(bias, torch.float32))
        else:
            self.bias = None

    @classmethod
    def from_observed(cls, layer, weight_quanter, act_quanter):
        """Build from a calibrated/trained QuantedWrapper's pieces: a
        Linear plus its weight/activation quanters (both must hold
        scales — PTQ-observed or QAT-trained)."""
        from .functional import quant_tensor

        w = layer.weight._t.detach()
        ws = weight_quanter.scales()._t.float()
        if ws.dim() > 0 and weight_quanter.quant_axis not in (1, None):
            raise ValueError(
                "QuantizedLinear needs per-OUT-channel weight scales "
                f"(quant_axis=1) or per-tensor; got quant_axis="
                f"{weight_quanter.quant_axis} — the per-in scale does "
                "not factor out of an int8 contraction")
        sa = act_quanter.scales()._t.float()
        if sa.dim() > 0:
            raise ValueError(
                "QuantizedLinear needs a PER-TENSOR activation scale; "
                f"got shape {tuple(sa.shape)} (per-channel act quant "
                "does not factor out of the int8 contraction)")
        q = quant_tensor(w, ws if ws.dim() == 0 else ws[None, :],
                         bits=weight_quanter.bit_length)
        bias = getattr(layer, "bias", None)
        return cls(q, ws, sa, bias=None if bias is None else bias._t,
                   bits=weight_quanter.bit_length)

    def forward(self, x):
        from .functional import quant_tensor

        qmax = _qmax(self._bits)
        bits = self._bits
        qw = self.qweight._t
        ws = self.w_scale._t
        sa = self.act_scale._t
        b = None if self.bias is None else self.bias._t

        def f(xa):
            xq = quant_tensor(xa, sa, bits=bits)
            y32 = int8_product(xq.reshape(-1, xq.shape[-1]), qw)
            y32 = y32.reshape(*xq.shape[:-1], qw.shape[1])
            # one rescale: (sa/qmax) * (ws/qmax), ws broadcasts over the
            # output channel
            y = y32.to(torch.float32) * (torch.clamp_min(sa, 1e-9) / qmax) \
                * (torch.clamp_min(ws, 1e-9) / qmax)
            return y if b is None else y + b
        return apply_op(f, x, op_name="quantized_linear")

    def extra_repr(self):
        return (f"in={self.qweight.shape[0]}, out={self.qweight.shape[1]}"
                f", bits={self._bits}, int8_compute=True")


class QuantizedConv2D(Layer):
    """Conv with int8-stored weights + activation quant-dequant at the
    calibrated scale; see module docstring for why the conv itself runs
    in float."""

    def __init__(self, conv, qweight, w_scale, act_scale, bits=8):
        super().__init__()
        self._conv = conv
        self._bits = int(bits)
        self.register_buffer("qweight", _buffer(qweight, torch.int8))
        self.register_buffer("w_scale", _buffer(w_scale, torch.float32))
        self.register_buffer("act_scale",
                             _buffer(act_scale, torch.float32))
        # the float weight is rebuilt from int8 at forward; drop the
        # original parameter so the exported artifact carries int8 only
        self._conv.weight = None

    @classmethod
    def from_observed(cls, layer, weight_quanter, act_quanter):
        from .functional import quant_tensor

        sa = act_quanter.scales()._t.float()
        if sa.dim() > 0:
            raise ValueError(
                "QuantizedConv2D needs a PER-TENSOR activation scale; "
                f"got shape {tuple(sa.shape)}")
        w = layer.weight._t.detach()
        ws = weight_quanter.scales()._t.float()
        axis = weight_quanter.quant_axis
        if ws.dim() > 0:
            shape = [1] * w.dim()
            shape[0 if axis is None else axis] = -1
            q = quant_tensor(w, ws.reshape(shape),
                             bits=weight_quanter.bit_length)
        else:
            q = quant_tensor(w, ws, bits=weight_quanter.bit_length)
        self_ = cls(layer, q, ws, sa, bits=weight_quanter.bit_length)
        self_._w_quant_axis = axis
        return self_

    def forward(self, x):
        from .functional import dequant_tensor, fake_quant_dequant

        bits = self._bits
        ws = self.w_scale._t
        if ws.dim() > 0:
            shape = [1] * self.qweight._t.dim()
            shape[getattr(self, "_w_quant_axis", 0) or 0] = -1
            ws = ws.reshape(shape)
        w = dequant_tensor(self.qweight._t, ws, bits=bits)
        sa = self.act_scale._t
        xa = apply_op(lambda a: fake_quant_dequant(a, sa, bits=bits),
                      x, op_name="quant_dequant_act")
        # a plain attribute while the call runs: not a parameter, so it
        # never enters the state that jit.save writes
        self._conv.weight = Tensor._wrap(w)
        try:
            return self._conv(xa)
        finally:
            self._conv.weight = None
