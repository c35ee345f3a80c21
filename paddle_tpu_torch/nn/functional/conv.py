"""Convolution functionals (the port of
``paddle_tpu/nn/functional/conv.py``).

The reference lowers every conv to ``lax.conv_general_dilated``; here
each is torch's ``conv{1,2,3}d`` / ``conv_transpose{1,2,3}d`` (cuDNN on
the card) on channels-first tensors, with the reference's padding
rules:

- ``padding`` is an int, a per-dimension list, a ``2 n`` list of
  (low, high) pairs, the full nested form, or ``"SAME"`` / ``"VALID"``.
  ``"SAME"`` is XLA's split at any stride (low = total // 2, the rest
  high), which torch's ``padding="same"`` refuses above stride 1; an
  asymmetric pair pads the input first.
- The transposed conv is the reference's ``lhs_dilation`` form over an
  ``IO``-laid weight, which does not flip the kernel: it equals torch's
  transposed conv with the weight flipped on its spatial axes.  Its
  padding is ``k_eff - 1 - p`` low and ``k_eff - 1 - p + output_padding``
  high on the dilated input; ``output_size`` is accepted and unused.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.tensor import apply_op
from ...ops.registry import register, _ensure_tensor

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _pad_cfg(padding, n):
    """The reference's padding forms as ``n`` (low, high) pairs, or the
    string ``"SAME"`` / ``"VALID"``."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        # full form [[0,0],[0,0],[ph,ph],[pw,pw]]: the spatial entries
        return [tuple(p) for p in padding[-n:]]
    return [(int(p), int(p)) for p in padding]


def _same_pads(sizes, window, strides):
    """XLA's ``"SAME"``: out = ceil(in / s), the total split low = half."""
    pads = []
    for n, k, s in zip(sizes, window, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve_pads(pad, sizes, window, strides):
    if pad == "SAME":
        return _same_pads(sizes, window, strides)
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    return [tuple(int(v) for v in p) for p in pad]


def _torch_pad_arg(pads):
    """(low, high) per spatial dim, first dim first, as ``F.pad``'s
    list (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nd, op_name):
    x = _ensure_tensor(x)
    weight = _ensure_tensor(weight)
    stride = _tuplize(stride, nd)
    dilation = _tuplize(dilation, nd)
    pad = _pad_cfg(padding, nd)
    channels_last = data_format.endswith("C")
    ks = weight.shape[2:]
    k_eff = [(k - 1) * d + 1 for k, d in zip(ks, dilation)]

    args = [x, weight]
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(a, w, b=None):
        if channels_last:
            a = a.movedim(-1, 1)
        pads = _resolve_pads(pad, a.shape[2:], k_eff, stride)
        if all(lo == hi and lo >= 0 for lo, hi in pads):
            sym = tuple(lo for lo, _ in pads)
        else:
            a = tF.pad(a, _torch_pad_arg(pads))
            sym = 0
        out = _CONV[nd](a, w, b, stride, sym, dilation, groups)
        return out.movedim(1, -1) if channels_last else out
    return apply_op(_f, *args, op_name=op_name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCH" if data_format in ("NCL", "NCH") else "NHC"
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 fmt, 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, nd, op_name,
                    output_size=None):
    x = _ensure_tensor(x)
    weight = _ensure_tensor(weight)
    stride = _tuplize(stride, nd)
    dilation = _tuplize(dilation, nd)
    outpad = _tuplize(output_padding, nd)
    channels_last = data_format.endswith("C")
    ks = weight.shape[2:]
    k_eff = [(k - 1) * d + 1 for k, d in zip(ks, dilation)]
    pad_str = padding.upper() if isinstance(padding, str) else None
    base = None if pad_str else _pad_cfg(padding, nd)

    args = [x, weight]
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(a, w, b=None):
        if channels_last:
            a = a.movedim(-1, 1)
        sizes = a.shape[2:]
        # the reference's pads on the stride-dilated input
        if pad_str is not None:
            dil_sizes = [(n - 1) * s + 1 for n, s in zip(sizes, stride)]
            pads = _resolve_pads(pad_str, dil_sizes, k_eff, [1] * nd)
        else:
            pads = [(k - 1 - lo, k - 1 - hi + op)
                    for k, (lo, hi), op in zip(k_eff, base, outpad)]
        wf = torch.flip(w, list(range(2, 2 + nd)))
        # torch's transposed conv pads k_eff - 1 - p low, and
        # k_eff - 1 - p + output_padding high (output_padding < stride
        # or dilation): take that form when the pads fit it, else the
        # full output (p = 0) cropped or padded to the pads
        tp = [k - 1 - lo for k, (lo, _) in zip(k_eff, pads)]
        op = [hi - lo for lo, hi in pads]
        if all(p >= 0 for p in tp) and all(
                0 <= o < max(s, d) for o, s, d in zip(op, stride, dilation)):
            out = _CONV_T[nd](a, wf, b, stride, tp, op, groups, dilation)
        else:
            out = _CONV_T[nd](a, wf, None, stride, 0, 0, groups, dilation)
            out = tF.pad(out, _torch_pad_arg(
                [(lo - (k - 1), hi - (k - 1))
                 for k, (lo, hi) in zip(k_eff, pads)]))
            if b is not None:
                out = out + b.reshape([1, -1] + [1] * nd)
        return out.movedim(1, -1) if channels_last else out
    return apply_op(_f, *args, op_name=op_name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    fmt = "NCH" if data_format in ("NCL", "NCH") else "NHC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, fmt, 1, "conv1d_transpose",
                           output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2,
                           "conv2d_transpose", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3,
                           "conv3d_transpose", output_size)


for _n in __all__:
    register(_n, globals()[_n])
