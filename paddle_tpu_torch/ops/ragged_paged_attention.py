"""Ragged paged attention: mixed prefill + decode attention over a paged
KV cache.

Layout (``paddle_tpu``'s, kept at the public function):

  q            [R, nkv, Tr, d]   Tr = Tc * rep token slots per request;
                                 row t*rep + j is q head h*rep + j of
                                 token t; request r uses its first
                                 q_lens[r] tokens, the rest is padding
  k/v pages    [nkv, P, page, d] pools
  block_tables [R, Bmax] int32   pool page of each logical kv block;
                                 unused entries hold 0, the null page
  seq_lens     [R] int32         kv length including this chunk
  q_lens       [R] int32         tokens in this chunk (0 = empty slot)
  k/v_scales   [nkv, P] f32      with int8 pools only: page (h, p)
                                 dequantizes as int8 * scale[h, p]

``ragged_paged_attention`` launches the hand-written kernel in
``csrc/ragged_paged_attention.cu`` for CUDA tensors (it replaces
``paddle_tpu/ops/pallas_ops.py::_rpa_kernel``, and ``_rpa_kernel_quant``
for int8 pools; the source says what bounds them and how its design
answers that) and runs the plain version, ``_ragged_attention_plain``,
for CPU tensors.  Padding rows come out as exact zeros in both.
Launches over dense pools count on ``ragged_paged_attention.launches``,
over int8 pools on ``ragged_paged_attention.quant_launches``.

The kernel is one launch a call.  Its grid splits each request's page
walk over S blocks (flash decoding) and the last block of each
(request, head, row tile) combines the splits' partials.
``_split_plan`` decides S from shapes only (no host read of
``seq_lens``/``q_lens``): enough blocks for several a multiprocessor,
never more splits than pages, fewer as the other grid axes fill the
card.  Tiles of at most 16 q rows (decode, GQA decode, short chunks,
any float32 q) run on the CUDA cores with q in registers; tiles of 64
bfloat16 rows (chunk prefill) run on the tensor cores.  The partials go
to a float32 workspace allocated per call; the tickets live in one
fixed int32 buffer per device that the kernel leaves zeroed, so the
call can be captured in a CUDA graph (calls on one device run on one
stream at a time).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from ..profiler import numerics as _numerics
from . import _build

__all__ = ["ragged_paged_attention"]

_NEG_BIG = -1e30  # finite mask value: -inf would NaN fully masked rows


def _ragged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                            q_lens, rep, k_scales=None, v_scales=None):
    """Plain PyTorch version (the port of ``_ragged_attention_jnp``):
    gather every request's pages into a dense [R, Bmax*page] kv span,
    mask, softmax, all in f32.  With per-page scales (int8 pools) the
    pages dequantize at the gather: scale first, dot second, as
    ``_rpa_kernel_quant`` does."""
    R, nkv, Tr, d = q.shape
    page = k_pages.shape[2]
    Bmax = block_tables.shape[1]
    flat = block_tables.reshape(-1).long()
    k_seq = k_pages.index_select(1, flat)          # [nkv, R*Bmax, page, d]
    v_seq = v_pages.index_select(1, flat)
    if k_scales is not None:
        k_seq = k_seq.float() * k_scales.index_select(1, flat)[
            :, :, None, None]
    if v_scales is not None:
        v_seq = v_seq.float() * v_scales.index_select(1, flat)[
            :, :, None, None]
    k_seq = k_seq.reshape(nkv, R, Bmax * page, d)
    v_seq = v_seq.reshape(nkv, R, Bmax * page, d)
    scale = 1.0 / math.sqrt(float(d))
    s = torch.einsum("rhtd,hrsd->rhts", q.float(), k_seq.float()) * scale
    dev = q.device
    seq_lens = seq_lens.to(dev, torch.int32)
    q_lens = q_lens.to(dev, torch.int32)
    tok = torch.arange(Tr, dtype=torch.int32, device=dev) // rep
    qpos = (seq_lens - q_lens)[:, None] + tok[None, :]             # [R, Tr]
    kpos = torch.arange(Bmax * page, dtype=torch.int32, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < seq_lens[:, None, None])
            & (tok[None, :, None] < q_lens[:, None, None]))
    s = torch.where(mask[:, None], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rhts,hrsd->rhtd", p, v_seq.float())
    valid = tok[None, :] < q_lens[:, None]                         # [R, Tr]
    return torch.where(valid[:, None, :, None], o, 0.0).to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
PAGE_MULTIPLE = 8  # the kernel serves any page size that is a multiple of 8


MMA_ROWS = 64          # q rows a tile of the tensor-core kernel
_CHUNK = 8             # keys a ring stage of the rows kernel
# blocks a multiprocessor the split aims at, rows kernel and tensor-core
# kernel, from a sweep of chip_smoke.py's rpa_phase (PERF.md, Findings):
# the decode over ragged lengths is fastest at 8.
# _ROWS_PER_SM >= 4 * _MMA_PER_SM keeps S from growing where a call of
# 16 rows (4 int8 row tiles) becomes one of 17 (one tensor-core tile).
_ROWS_PER_SM = 8
_MMA_PER_SM = 2
_MIN_SPLIT_KEYS = 64   # a split walks at least this many keys of Bmax
_MAX_SPLITS = 32       # the combine keeps S * rows weights in smem

SplitPlan = collections.namedtuple("SplitPlan", "rows ntiles S ws_shape")


def _max_rows(d, kv_bytes):
    """Most q rows a rows-kernel tile holds (the source's
    ``RowGeom::kMaxRows``): each lane keeps a 16-byte slice of a key row
    (E elements) of every q row and of its accumulator, ROWS * E <= 64
    floats each, and the scores of its chunk passes, U * ROWS <= 32."""
    e = 16 // kv_bytes
    passes = _CHUNK // (32 // (d // e))
    return min(64 // e, 32 // passes, 16)


def _tile_rows(Tr, d, q_dtype, kv_dtype):
    """q rows a tile: 64 on the tensor cores for more than 16 bf16 rows,
    else the power of two at or above Tr, capped by ``_max_rows``."""
    if Tr > 16 and q_dtype == torch.bfloat16:
        return MMA_ROWS
    return min(_max_rows(d, kv_dtype.itemsize), 1 << (Tr - 1).bit_length())


@functools.lru_cache(maxsize=256)
def _split_plan(R, nkv, Tr, Bmax, page, sms, d=128,
                q_dtype=torch.bfloat16, kv_dtype=None):
    """The kernel's grid from shapes alone: ``SplitPlan(rows, ntiles, S,
    ws_shape)``.  S splits each (request, head, row tile)'s page walk so
    that the grid holds about ``_ROWS_PER_SM`` (rows kernel) or
    ``_MMA_PER_SM`` (tensor-core kernel) blocks a multiprocessor, a split
    keeps at least ``_MIN_SPLIT_KEYS`` keys of Bmax * page, and
    1 <= S <= min(Bmax, ``_MAX_SPLITS``).  The workspace holds each
    split's partial in float32 when S > 1: acc [rows, d], then m and l
    [rows], padded to 16 bytes (``ws_shape`` None when S == 1)."""
    kv_dtype = q_dtype if kv_dtype is None else kv_dtype
    rows = _tile_rows(Tr, d, q_dtype, kv_dtype)
    ntiles = -(-Tr // rows)
    blocks = max(1, R * nkv * ntiles)
    per_sm = _MMA_PER_SM if rows == MMA_ROWS else _ROWS_PER_SM
    want = -(-per_sm * sms // blocks)
    S = max(1, min(want, Bmax * page // _MIN_SPLIT_KEYS, Bmax,
                   _MAX_SPLITS))
    part = rows * d + -(-2 * rows // 4) * 4
    ws = (R, nkv, ntiles, S, part) if S > 1 else None
    return SplitPlan(rows, ntiles, S, ws)


def _plan_for(q, k_pages, block_tables):
    """The plan a call on these CUDA tensors launches with."""
    R, nkv, Tr, d = q.shape
    return _split_plan(R, nkv, Tr, block_tables.shape[1], k_pages.shape[2],
                       _build.sm_count(q.device), d, q.dtype,
                       k_pages.dtype)


_TICKET_SLOTS = 1 << 14
_TICKETS = {}   # device index -> int32 [_TICKET_SLOTS], zero between calls


def _tickets(device, n):
    """The device's split tickets, one a (request, head, row tile).  The
    buffer is allocated once at a fixed size and never replaced, so a
    CUDA graph captured over a call keeps a live pointer.  Calls on one
    device share it: they run on one stream at a time, as the engine's
    do.  A split call has fewer tiles than ``_ROWS_PER_SM`` blocks a
    multiprocessor, far under the slots."""
    if n > _TICKET_SLOTS:
        raise ValueError(f"ragged_paged_attention: {n} split tiles > "
                         f"{_TICKET_SLOTS} ticket slots")
    buf = _TICKETS.get(device.index)
    if buf is None:
        buf = torch.zeros(_TICKET_SLOTS, dtype=torch.int32, device=device)
        _TICKETS[device.index] = buf
    return buf


def _lib(quant=False):
    lib = _build.load("ragged_paged_attention")
    fn = lib.rpa_quant_launch if quant else lib.rpa_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ptrs = 11 if quant else 9
        fn.argtypes = [p] * ptrs + [i] * 12 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_scales(k_pages, v_pages, k_scales, v_scales):
    """int8 pools come with f32 [nkv, P] contiguous scales, and scales
    only with int8 pools."""
    quant = k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if quant and k_scales is None:
        raise ValueError("int8 pools need k_scales and v_scales")
    if k_scales is None:
        return
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"scales go with int8 pools, got "
                        f"{k_pages.dtype} / {v_pages.dtype}")
    want = (k_pages.shape[0], k_pages.shape[1])
    for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if sc.dtype != torch.float32 or tuple(sc.shape) != want \
                or not sc.is_contiguous() or sc.device != k_pages.device:
            raise ValueError(f"{name} must be contiguous float32 {want} on "
                             f"{k_pages.device}, got {sc.dtype} "
                             f"{tuple(sc.shape)} on {sc.device}")


def _ragged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                           q_lens, rep, k_scales=None, v_scales=None):
    R, nkv, Tr, d = q.shape
    P, page = k_pages.shape[1], k_pages.shape[2]
    Bmax = block_tables.shape[1]
    quant = k_scales is not None
    if q.dtype not in _DTYPES:
        raise TypeError(f"ragged_paged_attention kernel takes float32 or "
                        f"bfloat16 q, got {q.dtype}")
    if not quant and (k_pages.dtype != q.dtype
                      or v_pages.dtype != q.dtype):
        raise TypeError("ragged_paged_attention kernel takes pools of q's "
                        f"dtype or int8 pools with scales, got "
                        f"{q.dtype} / {k_pages.dtype} / {v_pages.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"ragged_paged_attention kernel takes head dim "
                         f"{_HEAD_DIMS}, got {d}")
    if page % PAGE_MULTIPLE:
        raise ValueError(f"ragged_paged_attention kernel takes a page size "
                         f"that is a multiple of {PAGE_MULTIPLE}, got {page}")
    if Tr % rep:
        raise ValueError(f"q rows {Tr} are not a multiple of rep {rep}")
    if tuple(k_pages.shape) != (nkv, P, page, d) \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.shape[0] != R or seq_lens.numel() != R \
            or q_lens.numel() != R:
        raise ValueError("block_tables / seq_lens / q_lens need one row "
                         "per request")
    ints = [t.to(device=q.device, dtype=torch.int32).contiguous()
            for t in (block_tables, seq_lens, q_lens)]
    q = q.contiguous()
    k_pages = k_pages.contiguous()
    v_pages = v_pages.contiguous()
    # the kernel loads every page, and q, 16 bytes a thread
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pools must start 16-byte aligned")
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty_like(q)
    plan = _plan_for(q, k_pages, block_tables)
    ws = (None if plan.ws_shape is None else
          torch.empty(plan.ws_shape, dtype=torch.float32, device=q.device))
    cnt = (None if ws is None else
           _tickets(q.device, R * nkv * plan.ntiles).data_ptr())
    scale = 1.0 / math.sqrt(float(d))
    tail = (out.data_ptr(), None if ws is None else ws.data_ptr(), cnt,
            _DTYPES[q.dtype],
            R, nkv, Tr, d, P, page, Bmax, rep, plan.rows, plan.ntiles,
            plan.S, scale, _build.stream_ptr(q.device))
    if quant:
        err = _lib(quant=True)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), ints[0].data_ptr(),
            ints[1].data_ptr(), ints[2].data_ptr(), *tail)
        _build.check(err, "ragged_paged_attention (int8 pools)")
        ragged_paged_attention.quant_launches += 1
        return out
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
                 *tail)
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           q_lens, *, rep=1, k_scales=None, v_scales=None):
    """Mixed prefill + decode attention over a paged KV cache (layout in
    the module docstring); decode is the Tc == 1 case of the same call.
    int8 pools take ``k_scales``/``v_scales`` ([nkv, P] f32, contiguous)
    and only they do.  CUDA tensors go through the kernel (page a
    multiple of 8, head dim 64 or 128), CPU tensors through the plain
    version; any other device raises."""
    _check_scales(k_pages, v_pages, k_scales, v_scales)
    if q.device.type == "cuda":
        fn = _ragged_attention_cuda
    elif q.device.type == "cpu":
        fn = _ragged_attention_plain
    else:
        raise RuntimeError(
            f"ragged_paged_attention: no kernel for device {q.device}")
    name = ("ragged_paged_attention_quant" if k_scales is not None
            else "ragged_paged_attention")
    return _numerics.opaque(name, fn, q, k_pages, v_pages, block_tables,
                            seq_lens, q_lens, rep, k_scales, v_scales)


ragged_paged_attention.launches = 0        # dense-pool kernel launches
ragged_paged_attention.quant_launches = 0  # int8-pool kernel launches
