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

``ragged_paged_attention`` launches the hand-written kernel in
``csrc/ragged_paged_attention.cu`` for CUDA tensors (it replaces
``paddle_tpu/ops/pallas_ops.py::_rpa_kernel``; the source says what
bounds it) and runs the plain version, ``_ragged_attention_plain``, for
CPU tensors.  Padding rows come out as exact zeros in both.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["ragged_paged_attention"]

_NEG_BIG = -1e30  # finite mask value: -inf would NaN fully masked rows


def _ragged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                            q_lens, rep):
    """Plain PyTorch version (the port of ``_ragged_attention_jnp``):
    gather every request's pages into a dense [R, Bmax*page] kv span,
    mask, softmax, all in f32."""
    R, nkv, Tr, d = q.shape
    page = k_pages.shape[2]
    Bmax = block_tables.shape[1]
    flat = block_tables.reshape(-1).long()
    k_seq = k_pages.index_select(1, flat).reshape(nkv, R, Bmax * page, d)
    v_seq = v_pages.index_select(1, flat).reshape(nkv, R, Bmax * page, d)
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


def _lib():
    lib = _build.load("ragged_paged_attention")
    fn = lib.rpa_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _ragged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                           q_lens, rep):
    R, nkv, Tr, d = q.shape
    P, page = k_pages.shape[1], k_pages.shape[2]
    Bmax = block_tables.shape[1]
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError("ragged_paged_attention kernel takes float32 or "
                        f"bfloat16 q and pools of the same dtype, got "
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
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
                 out.data_ptr(), _DTYPES[q.dtype], R, nkv, Tr, d, P, page,
                 Bmax, rep, 1.0 / math.sqrt(float(d)),
                 _build.stream_ptr(q.device))
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           q_lens, *, rep=1):
    """Mixed prefill + decode attention over a paged KV cache (layout in
    the module docstring); decode is the Tc == 1 case of the same call.
    CUDA tensors go through the kernel (page a multiple of 8, head dim
    64 or 128), CPU tensors through the plain version; any other device
    raises."""
    if q.device.type == "cuda":
        return _ragged_attention_cuda(q, k_pages, v_pages, block_tables,
                                      seq_lens, q_lens, rep)
    if q.device.type == "cpu":
        return _ragged_attention_plain(q, k_pages, v_pages, block_tables,
                                       seq_lens, q_lens, rep)
    raise RuntimeError(
        f"ragged_paged_attention: no kernel for device {q.device}")


ragged_paged_attention.launches = 0  # kernel launches since last reset
