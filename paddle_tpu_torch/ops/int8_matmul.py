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
import functools
from typing import NamedTuple, Tuple

import torch

from ..profiler import numerics as _numerics
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

# The kernel's launch plan (``csrc/int8_matmul.cu`` says why): block
# tiles of 128 columns fed through a ring of k stages, two regimes
# chosen by M, K split over the blocks of one cluster.
_BN = 128                 # block columns
_STREAM_ROWS = 16         # the stream regime's tile rows: M it can serve
# M up to which one streaming launch serves a call: at M = 16 the rows
# regime reads as fast or faster on llama7b's shapes, at M = 8 slower on
# three of four (``chip_smoke.py``'s ``int8_plans``, PERF.md)
_STREAM_MAX_M = 8
_MAX_SPLIT = 8            # k splits: the blocks of one cluster (portable max)
_BLOCKS_PER_SM = 2        # split K until the grid holds this many a SM
# each block shape by its tile rows: (k bytes a stage, ring stages), the
# kernel's StreamCfg, Rows64Cfg and Rows128Cfg
_SHAPES = {16: (64, 5), 64: (64, 4), 128: (128, 3)}
_GRID_Y_MAX = 65535


class SplitPlan(NamedTuple):
    rows: int      # tile rows: 16 = the stream regime, 64 / 128 = rows
    tiles_m: int   # grid x
    tiles_n: int   # grid y
    S: int         # grid z = cluster size: k splits
    kslice: int    # k of one split, a multiple of the shape's stage
    smem: int      # dynamic shared memory a block

    @property
    def launches(self) -> int:
        """Kernels a call launches: the stream GEMM alone, or the
        row-quant pre-pass and the GEMM."""
        return 1 if self.rows == _STREAM_ROWS else 2


def _smem_bytes(rows: int, xbytes: int) -> int:
    """The kernel's dynamic shared memory (``Cfg::smem`` in the source):
    the larger of the ring and the int32 partial tile the cluster sums,
    then (stream) one stage's quantized x.  A stage holds the weight tile
    and the A rows: int8 xq, or x itself (``xbytes`` an element) in the
    stream regime."""
    bk, stages = _SHAPES[rows]
    stream = rows == _STREAM_ROWS
    stage = rows * bk * (xbytes if stream else 1) + bk * _BN
    part = rows * (_BN + 4) * 4
    return max(stages * stage, part) + (rows * bk if stream else 0)


@functools.lru_cache(maxsize=1024)
def _split_plan(M: int, K: int, N: int, sms: int,
                stream_rows: int = _STREAM_MAX_M,
                xbytes: int = 2) -> SplitPlan:
    """The launch of one call, from shapes only.  M <= ``stream_rows``
    (at most 16) runs the stream regime; larger M 64- or 128-row tiles.
    K is split (S <= 8, every split non-empty) until the grid holds
    ``_BLOCKS_PER_SM`` blocks a multiprocessor.  ``xbytes``: bytes of an
    activation (a streaming block stages x in its ring)."""
    if min(M, K, N) < 1:
        raise ValueError(f"int8_matmul: empty shape M={M} K={K} N={N}")
    if stream_rows > _STREAM_ROWS:
        raise ValueError(f"int8_matmul: the stream regime takes at most "
                         f"{_STREAM_ROWS} rows, not {stream_rows}")
    if M <= stream_rows:
        rows = _STREAM_ROWS
    else:
        rows = 64 if M <= 64 else 128
    bk = _SHAPES[rows][0]
    tiles_m, tiles_n = -(-M // rows), -(-N // _BN)
    if tiles_n > _GRID_Y_MAX:
        raise ValueError(f"int8_matmul: N={N} needs {tiles_n} column tiles "
                         f"> {_GRID_Y_MAX}")
    S = (_BLOCKS_PER_SM * sms) // (tiles_n * tiles_m)
    S = max(1, min(_MAX_SPLIT, S, -(-K // bk)))
    kslice = -(-(-(-K // S)) // bk) * bk
    S = -(-K // kslice)
    return SplitPlan(rows, tiles_m, tiles_n, S, kslice,
                     _smem_bytes(rows, xbytes))


def _plan_for(x: torch.Tensor, w_q: torch.Tensor,
              stream_rows: int = _STREAM_MAX_M) -> SplitPlan:
    """The plan a call on these CUDA tensors (x [M, K]) launches with."""
    return _split_plan(x.shape[0], x.shape[1], w_q.shape[1],
                       _build.sm_count(x.device), stream_rows,
                       x.element_size())


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel's vector
    loads); a copy when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      stream_rows: int = _STREAM_MAX_M) -> torch.Tensor:
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
    plan = _plan_for(x, w_q, stream_rows)
    x, w_q, w_scale = _aligned(x), _aligned(w_q), _aligned(w_scale)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if plan.rows == _STREAM_ROWS:
        xq = xs = None
    else:
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), _DTYPES[x.dtype], w_q.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(),
                 None if xq is None else xq.data_ptr(),
                 None if xs is None else xs.data_ptr(), M, K, N, plan.rows,
                 plan.S, plan.kslice, _build.stream_ptr(x.device))
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
        fn = _int8_matmul_cuda
    elif x.device.type == "cpu":
        fn = _int8_matmul_plain
    else:
        raise RuntimeError(f"int8_matmul: no kernel for device {x.device}")
    return _numerics.opaque("int8_matmul", fn, x2, w_q, ws).reshape(*lead, N)


int8_matmul.launches = 0  # kernel launches since the caller last reset it
