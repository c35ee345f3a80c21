"""Pooling functionals (the port of
``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window`` and its adaptive pools
with ``jnp.max`` / ``jnp.mean``.  Here torch's pools take the padding
where theirs gives the same windows (symmetric, at most half the
window); otherwise the input is padded first (``-inf`` for max, zeros
for the sums) and pooled without, so that the windows are the
reference's whatever the padding:

- ``ceil_mode`` widens the high side until the trailing partial window
  is kept (the reference's rule, not torch's, which drops a window that
  starts in the padding).
- An average divides by the window's size, except once ``ceil_mode``
  has widened, or when ``exclusive`` is set with padding: then by the
  count of real elements in the window.  So with ``ceil_mode`` and
  ``exclusive=False`` the divisor is not torch's ``count_include_pad``.
- The adaptive pools reduce one axis at a time with ``torch.amax`` /
  ``mean``: like ``jnp.max``, ``amax`` splits a tied maximum's gradient
  evenly, where ``adaptive_max_pool2d`` routes it to one element.
- ``return_mask`` gives the argmax's flat index over the input's
  H·W (D·H·W) plane, which ``max_unpool*d`` consumes; the values'
  gradient then splits ties evenly as the reference's ``jnp.max`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ...core.tensor import apply_op
from ...ops.registry import register, _ensure_tensor
from .conv import _pad_cfg, _resolve_pads, _torch_pad_arg, _tuplize

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d",
           "max_unpool2d"]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _window_pads(sizes, kernel, stride, pad, ceil_mode):
    """The reference's (low, high) pads and whether ``ceil_mode``
    widened one."""
    pads = _resolve_pads(pad, sizes, kernel, stride)
    widened = False
    if ceil_mode and not isinstance(pad, str):
        for i, (n, k, s) in enumerate(zip(sizes, kernel, stride)):
            lo, hi = pads[i]
            rem = (n + lo + hi - k) % s
            if rem:
                pads[i] = (lo, hi + s - rem)
                widened = True
    return pads, widened


def _pool(x, kernel, stride, padding, nd, is_max, channels_last,
          ceil_mode=False, count_include_pad=True, op_name="pool"):
    x = _ensure_tensor(x)
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride if stride is not None else kernel, nd)
    pad = _pad_cfg(padding, nd)

    def _f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        sizes = a.shape[2:]
        pads, widened = _window_pads(sizes, kernel, stride, pad, ceil_mode)
        padded = any(p != (0, 0) for p in pads)
        by_window = not widened and (count_include_pad
                                     or isinstance(pad, str) or not padded)
        if not widened and all(lo == hi and lo <= k // 2
                               for (lo, hi), k in zip(pads, kernel)):
            # torch's own padding gives the same windows and divisors
            p = tuple(lo for lo, _ in pads)
            out = _MAX[nd](a, kernel, stride, p) if is_max else _AVG[nd](
                a, kernel, stride, p, count_include_pad=by_window)
        elif is_max:
            out = _MAX[nd](tF.pad(a, _torch_pad_arg(pads), value=-math.inf),
                           kernel, stride)
        else:
            if padded:
                a = tF.pad(a, _torch_pad_arg(pads))
            out = _AVG[nd](a, kernel, stride)
            if not by_window:
                # divide by the count of real elements in each window
                ones = torch.ones((1, 1) + tuple(sizes), dtype=a.dtype,
                                  device=a.device)
                if padded:
                    ones = tF.pad(ones, _torch_pad_arg(pads))
                counts = _AVG[nd](ones, kernel, stride)
                out = out / counts
        return out.movedim(1, -1) if channels_last else out
    return apply_op(_f, x, op_name=op_name)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        # the 2-D with-index pool on a width-1 axis: flat indices over
        # L * 1 are the 1-D positions max_unpool1d takes
        from ...tensor.manipulation import squeeze, transpose, unsqueeze
        nlc = data_format == "NLC"
        xt = _ensure_tensor(x)
        if nlc:
            xt = transpose(xt, [0, 2, 1])
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        s = stride if stride is None or isinstance(stride, int) \
            else stride[0]
        p = padding if isinstance(padding, int) else padding[0]
        out, idx = _max_pool_with_index(
            unsqueeze(xt, -1), (k, 1), (k if s is None else s, 1), (p, 0),
            False, ceil_mode, 2)
        out, idx = squeeze(out, -1), squeeze(idx, -1)
        if nlc:
            out = transpose(out, [0, 2, 1])
            idx = transpose(idx, [0, 2, 1])
        return out, idx
    return _pool(x, kernel_size, stride, padding, 1, True,
                 data_format.endswith("C") and data_format != "NCL",
                 ceil_mode, op_name="max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        kh, kw = _tuplize(kernel_size, 2)
        pad = _tuplize(padding, 2) \
            if not isinstance(padding, (list, tuple)) else tuple(padding)
        pad = pad if len(pad) == 2 else (pad[0], pad[0])
        return _max_pool_with_index(
            x, (kh, kw), _tuplize(stride if stride is not None
                                  else kernel_size, 2),
            pad, data_format == "NHWC", ceil_mode, 2)
    return _pool(x, kernel_size, stride, padding, 2, True,
                 data_format == "NHWC", ceil_mode, op_name="max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_index(
            x, _tuplize(kernel_size, 3),
            _tuplize(stride if stride is not None else kernel_size, 3),
            _tuplize(padding, 3), data_format == "NDHWC", ceil_mode, 3)
    return _pool(x, kernel_size, stride, padding, 3, True,
                 data_format == "NDHWC", ceil_mode, op_name="max_pool3d")


def _max_pool_with_index(x, kernel, stride, pad, channels_last, ceil_mode,
                         nd):
    """max_pool{2,3}d(return_mask=True): the values and the flat argmax
    index into the input's plane (volume), the contract max_unpool
    consumes.  The windows are stacked, as the reference stacks them:
    the first maximum in window order gives the index, and the values'
    gradient splits ties evenly (``amax``, as ``jnp.max``)."""
    x = _ensure_tensor(x)
    kernel, stride, pad = tuple(kernel), tuple(stride), tuple(pad)

    def _f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        sizes = a.shape[2:]
        outs = []
        for n, k, s, p in zip(sizes, kernel, stride, pad):
            outs.append((-((n + 2 * p - k) // -s) + 1) if ceil_mode
                        else (n + 2 * p - k) // s + 1)
        # the high side may exceed p under ceil_mode
        extra = [max((o - 1) * s + k - n - p, 0)
                 for o, s, k, n, p in zip(outs, stride, kernel, sizes, pad)]
        ap = tF.pad(a, _torch_pad_arg(list(zip(pad, extra))),
                    value=-math.inf)
        vals, gidx = [], []
        for offs in np.ndindex(*kernel):
            sl = tuple(slice(o, o + s * m, s)
                       for o, s, m in zip(offs, stride, outs))
            vals.append(ap[(slice(None), slice(None)) + sl])
            flat = torch.zeros(outs, dtype=torch.int64, device=a.device)
            for ax, (o, s, m, p, n) in enumerate(
                    zip(offs, stride, outs, pad, sizes)):
                pos = torch.arange(m, device=a.device) * s + o - p
                shape = [1] * nd
                shape[ax] = m
                flat = flat * n + pos.reshape(shape)
            gidx.append(flat.expand(a.shape[:2] + tuple(outs)))
        stack = torch.stack(vals)
        out = torch.amax(stack, 0)
        am = torch.argmax(stack, 0)
        idx = torch.gather(torch.stack(gidx), 0, am[None])[0]
        idx = idx.to(torch.int32)
        if channels_last:
            out, idx = out.movedim(1, -1), idx.movedim(1, -1)
        return out, idx
    return apply_op(_f, x, op_name=f"max_pool{nd}d_with_index", n_outs=2)


def _unpool(x, indices, out_sizes, nd, op_name):
    """Scatter the pooled values to the flat positions ``indices``
    recorded, in a zero output of spatial size ``out_sizes``."""
    def _f(a, idx):
        N, C = a.shape[:2]
        flat_v = a.reshape(N, C, -1)
        flat_i = idx.reshape(N, C, -1).long()
        out = torch.zeros((N, C, int(np.prod(out_sizes))), dtype=a.dtype,
                          device=a.device)
        out = out.scatter(2, flat_i, flat_v)
        return out.reshape((N, C) + tuple(out_sizes))
    return apply_op(_f, x, indices, op_name=op_name)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter pooled values back to the positions recorded by
    max_pool2d(return_mask=True)."""
    x = _ensure_tensor(x)
    indices = _ensure_tensor(indices)
    kh, kw = _tuplize(kernel_size, 2)
    sh, sw = _tuplize(stride if stride is not None else kernel_size, 2)
    ph, pw = _tuplize(padding, 2)
    channels_last = data_format == "NHWC"
    ih, iw = (x.shape[1:3] if channels_last else x.shape[2:4])
    if output_size is None:
        oh = (ih - 1) * sh - 2 * ph + kh
        ow = (iw - 1) * sw - 2 * pw + kw
    else:
        oh, ow = output_size[-2:]
    if channels_last:
        from ...tensor.manipulation import transpose
        out = _unpool(transpose(x, [0, 3, 1, 2]),
                      transpose(indices, [0, 3, 1, 2]), (oh, ow), 2,
                      "max_unpool2d")
        return transpose(out, [0, 2, 3, 1])
    return _unpool(x, indices, (oh, ow), 2, "max_unpool2d")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, False, False,
                 ceil_mode, count_include_pad=not exclusive,
                 op_name="avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, False,
                 data_format == "NHWC", ceil_mode,
                 count_include_pad=not exclusive, op_name="avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, False,
                 data_format == "NDHWC", ceil_mode,
                 count_include_pad=not exclusive, op_name="avg_pool3d")


def _adaptive_pool(x, output_size, nd, is_max, channels_last, op_name):
    x = _ensure_tensor(x)
    out_sizes = _tuplize(output_size, nd) \
        if not isinstance(output_size, (list, tuple)) \
        or None not in output_size else tuple(output_size)
    axes = list(range(1, 1 + nd)) if channels_last \
        else list(range(2, 2 + nd))

    def red(t, ax, keepdim):
        return torch.amax(t, ax, keepdim=keepdim) if is_max \
            else torch.mean(t, ax, keepdim=keepdim)

    def _f(a):
        out = a
        for i, ax in enumerate(axes):
            n_in = out.shape[ax]
            n_out = out_sizes[i]
            if n_out is None or n_out == n_in:
                continue
            if n_in % n_out == 0:
                shape = out.shape[:ax] + (n_out, n_in // n_out) \
                    + out.shape[ax + 1:]
                out = red(out.reshape(shape), ax + 1, False)
            else:
                # variable windows (torch-style bounds)
                starts = (np.arange(n_out) * n_in) // n_out
                ends = ((np.arange(n_out) + 1) * n_in + n_out - 1) // n_out
                out = torch.cat(
                    [red(out.narrow(ax, int(s), int(e - s)), ax, True)
                     for s, e in zip(starts, ends)], ax)
        return out
    return apply_op(_f, x, op_name=op_name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, False, False,
                          "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, False, data_format == "NHWC",
                          "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, False, data_format == "NDHWC",
                          "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, True, False,
                          "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, True, False,
                          "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, True, False,
                          "adaptive_max_pool3d")


def _lp_pool(x, norm_type, kernel_size, nd, pool):
    x = _ensure_tensor(x)
    p = float(norm_type)
    powed = apply_op(lambda a: a.abs() ** p, x, op_name="lp_pow")
    pooled = pool(powed)
    k = int(np.prod(_tuplize(kernel_size, nd)))
    return apply_op(lambda a: (a * k) ** (1.0 / p), pooled,
                    op_name="lp_root")


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, 1, lambda t: avg_pool1d(
        t, kernel_size, stride, padding, exclusive=False,
        ceil_mode=ceil_mode))


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    # the reference's lp_pool2d does not pass ceil_mode on
    return _lp_pool(x, norm_type, kernel_size, 2, lambda t: avg_pool2d(
        t, kernel_size, stride, padding, exclusive=False))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """1-D unpool: scatter back by the indices max_pool1d(return_mask)
    recorded."""
    from ...tensor.manipulation import transpose
    x = _ensure_tensor(x)
    indices = _ensure_tensor(indices)
    nlc = data_format == "NLC"
    if nlc:
        x, indices = transpose(x, [0, 2, 1]), transpose(indices, [0, 2, 1])
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (
        stride if isinstance(stride, int) else stride[0])
    p = padding if isinstance(padding, int) else padding[0]
    ol = output_size[-1] if output_size is not None \
        else (x.shape[-1] - 1) * s - 2 * p + k
    out = _unpool(x, indices, (ol,), 1, "max_unpool1d")
    return transpose(out, [0, 2, 1]) if nlc else out


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    """3-D unpool: indices are flat positions over the output D*H*W."""
    from ...tensor.manipulation import transpose
    x = _ensure_tensor(x)
    indices = _ensure_tensor(indices)
    ndhwc = data_format == "NDHWC"
    if ndhwc:
        x = transpose(x, [0, 4, 1, 2, 3])
        indices = transpose(indices, [0, 4, 1, 2, 3])
    kd, kh, kw = _tuplize(kernel_size, 3)
    sd, sh, sw = _tuplize(stride if stride is not None else kernel_size, 3)
    pd, ph, pw = _tuplize(padding, 3)
    idd, ih, iw = x.shape[2:5]
    if output_size is None:
        osz = ((idd - 1) * sd - 2 * pd + kd, (ih - 1) * sh - 2 * ph + kh,
               (iw - 1) * sw - 2 * pw + kw)
    else:
        osz = tuple(output_size[-3:])
    out = _unpool(x, indices, osz, 3, "max_unpool3d")
    return transpose(out, [0, 2, 3, 4, 1]) if ndhwc else out


for _n in __all__:
    register(_n, globals()[_n])
__all__ += ["max_unpool1d", "max_unpool3d"]
for _n in ("max_unpool1d", "max_unpool3d"):
    register(_n, globals()[_n])
