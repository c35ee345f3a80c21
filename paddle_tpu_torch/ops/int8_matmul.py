"""int8 weight matmul: y = dequant(quant_row(x) @ w_q).

Weights arrive pre-quantized (``quantize_int8``: symmetric per-output-
channel absmax); activations are quantized per row on the fly, the
int8 x int8 product accumulates exactly in int32, and the epilogue
dequantizes (``acc * x_scale * w_scale``) into x's dtype.

``int8_matmul`` launches the hand-written kernel in
``csrc/int8_matmul.cu`` for CUDA tensors (it replaces
``paddle_tpu/ops/pallas_ops.py::_int8_matmul_kernel``; the source says
what bounds it) and runs the plain version, ``_int8_matmul_plain``, for
CPU tensors.  The two agree bit for bit: same f32 operations in the same
order, IEEE division, round-half-even, one final rounding.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["quantize_int8", "int8_matmul"]

_INT8_EPS = 1e-8        # activation absmax floor: all-zero rows quantize to 0
_INV127 = 1.0 / 127.0   # float32(1/127): the kernel's constant too


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel absmax int8 quantization of a matmul
    weight ``[..., K, N]`` (contraction axis second to last): returns
    ``(q int8 same shape, scale f32 [..., 1, N])``.  All-zero and
    non-finite channels get the benign scale 1/127 instead of a denormal
    that underflows when a scale is stored in 16 bits (the dead-channel
    guard of ``paddle_tpu``'s ``quantize_int8``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    amax = torch.where(torch.isfinite(amax) & (amax > 0.0), amax,
                       torch.ones_like(amax))
    scale = amax / 127.0
    # NaN -> 0, then saturate: the float->int8 conversion of XLA
    q = torch.round(wf / scale).nan_to_num_(nan=0.0).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quantize_rows(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic activation quantization of ``xf`` [M, K] f32:
    ``(xq int8 [M, K], xs f32 [M, 1])``."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp_min(amax, _INT8_EPS) * _INV127
    xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return xq, xs


def _int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, ``x`` [M, K]: the op-for-op
    port of ``paddle_tpu``'s ``_int8_matmul_jnp``.  The int32
    accumulators are exact: an integer product on the CPU; on the card a
    float64 product, exact while 127 * 127 * K < 2**53."""
    xq, xs = _quantize_rows(x.float())
    if x.is_cuda:
        acc = (xq.double() @ w_q.double()).float()
    else:
        acc = (xq.int() @ w_q.int()).float()
    return ((acc * xs) * w_scale.float()).to(x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _int8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    M, K = x.shape
    N = w_q.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul kernel takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("int8_matmul kernel takes int8 weights and float32 "
                        f"scales, got {w_q.dtype} / {w_scale.dtype}")
    if w_q.shape[0] != K or w_scale.numel() != N:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} do not fit")
    if K % 4 or N % 4:
        raise ValueError(f"int8_matmul kernel needs K % 4 == 0 and "
                         f"N % 4 == 0, got K={K}, N={N}")
    if not (w_q.device == x.device == w_scale.device):
        raise ValueError("int8_matmul: tensors on different devices")
    x = x.contiguous()
    w_q = w_q.contiguous()
    w_scale = w_scale.contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    acc = torch.empty((M, N), dtype=torch.int32, device=x.device)
    err = _lib()(x.data_ptr(), _DTYPES[x.dtype], w_q.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), xq.data_ptr(),
                 xs.data_ptr(), acc.data_ptr(), M, K, N,
                 _build.stream_ptr(x.device))
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Activation-dynamic int8 matmul.

    x        [..., K] activations, float32 or bfloat16
    w_q      [K, N] int8 weights (``quantize_int8`` layout)
    w_scale  [1, N] (or [N]) f32 per-output-channel scales

    Returns [..., N] in x's dtype.  CUDA tensors go through the kernel
    (every M; K and N multiples of 4), CPU tensors through the plain
    version; any other device raises."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[1]
    x2 = x.reshape(-1, K)
    ws = w_scale.reshape(1, N)
    if x.device.type == "cuda":
        y = _int8_matmul_cuda(x2, w_q, ws)
    elif x.device.type == "cpu":
        y = _int8_matmul_plain(x2, w_q, ws)
    else:
        raise RuntimeError(f"int8_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, N)


int8_matmul.launches = 0  # kernel launches since the caller last reset it
