"""Flash causal attention, forward and backward (the port of
``paddle_tpu/ops/pallas_ops.py``'s flash section and its
``causal_attention`` custom VJP).

Layout, as at the reference's public function:

  q, k, v, o, do   [B, S, H, D]   (GQA kv heads are repeated by the
                                  caller, as ``models.llama._attention``
                                  does, so all carry H heads)
  lse, delta       [B, H, S] f32  row log-sum-exp of the scaled scores;
                                  delta = rowsum(do * o)

The reference kept ``lse`` replicated over 128 TPU lanes; that was a
TPU layout artifact and is not kept.

Two wrappers, each with a plain integer ``launches`` count of its
calls: ``flash_fwd`` -> (o, lse) and ``flash_bwd`` -> (dq, dk, dv), the
reference's ``_flash_bwd`` as one function.  CUDA tensors go to the
hand-written kernels in ``csrc/flash_attention.cu`` (bf16, head dim 64
or 128, any S >= 1; anything else raises), which read ``[B, S, H, D]``
in place through its row stride: the reference's ``_to_bh`` transposes
are gone.  The backward is three launches (a delta pre-pass, the main
kernel over 128-key tiles, a cast of the f32 dq sum); the key tiles add
their dq parts in a fixed order, so every output is the same bits from
call to call.  CPU tensors go to the plain versions, which materialise
the S x S scores in f32 as the kernels' math does.
``causal_attention`` is the ``torch.autograd.Function`` over them.
``flash_fwd`` runs through the custom op ``paddle_tpu_torch::flash_fwd``
(CUDA: the kernel; CPU: the plain version; a fake for captures), so a
graph captured by ``jit`` holds it as one node.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..profiler import numerics as _numerics
from . import _build

__all__ = ["causal_attention", "flash_fwd", "flash_bwd"]

_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card's yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def _causal_mask(S, device):
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def _scores(q, k):
    """Scaled q.k^T in f32, [B, H, S, S]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale


def _flash_fwd_plain(q, k, v):
    """``_attention_jnp`` (pallas_ops.py:275) with the row log-sum-exp
    kept: (o [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    s = _scores(q, k).masked_fill(~_causal_mask(q.shape[1], q.device),
                                  float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhst,bthd->bshd", p, v.float())
    return o.to(q.dtype), lse


def _probs(q, k, lse):
    """p = exp(s - lse) under the causal mask, [B, H, S, S] f32."""
    mask = _causal_mask(q.shape[1], q.device)
    return torch.where(mask, torch.exp(_scores(q, k) - lse[..., None]), 0.0)


def _delta(o, do):
    """rowsum(do * o) as [B, H, S] f32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def _flash_bwd_dq_plain(q, k, v, o, lse, do):
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(o, do)
    p = _probs(q, k, lse)
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale
    return dq.to(q.dtype), delta


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse)
    dv = torch.einsum("bhst,bshd->bthd", p, do.float())
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_plain(q, k, v, o, lse, do):
    """The backward pair in one: (dq, dk, dv) in the inputs' dtypes."""
    dq, delta = _flash_bwd_dq_plain(q, k, v, o, lse, do)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels (CUDA tensors)
# ---------------------------------------------------------------------------

_ARGTYPES = {
    # q k v o lse B S H d scale stream
    "flash_fwd_launch": 5 * ["p"] + 4 * ["i"] + ["f", "p"],
    # q k v o do lse dq dk dv delta dq_acc turns B S H d scale stream
    "flash_bwd_launch": 12 * ["p"] + 4 * ["i"] + ["f", "p"],
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _fn(name):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(what, q, *others):
    """Raise on what the kernels do not take; returns (B, S, H, D).
    Pure shape/dtype checks, so the CPU tests reach them too."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim {_HEAD_DIMS}, "
                         f"got {D}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"{what}: empty shape {tuple(q.shape)}")
    for t in others:
        if tuple(t.shape) != (B, S, H, D) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{what}: operand {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    return B, S, H, D


def _rows(t, B, H, S, what):
    if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
        raise ValueError(f"{what}: expected f32 [B, H, S] = {(B, H, S)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _ptrs(*ts):
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned tensors")
    return [t.data_ptr() for t in ts]


def _launch_fwd(q, k, v):
    """The forward kernel, uncounted: ``flash_fwd`` counts its launches,
    and ``fused_blocks.fused_attn_epilogue`` runs it as its first half."""
    B, S, H, D = _check_kernel_args("flash_fwd", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _fn("flash_fwd_launch")(*_ptrs(q, k, v, o, lse), B, S, H, D,
                                  1.0 / math.sqrt(D),
                                  _build.stream_ptr(q.device))
    _build.check(err, "flash_fwd")
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, do):
    """The backward's three launches, uncounted (``flash_bwd`` counts),
    with their workspaces: delta [B, H, S] and the dq sum [B, S, H, D]
    in f32, and the int32 turn counters of the ordered dq sum, one a
    (b*h, 64-row q tile, warpgroup of 64 keys); the kernels write all
    three before they read them."""
    B, S, H, D = _check_kernel_args("flash_bwd", q, k, v, o, do)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = _rows(lse, B, H, S, "flash_bwd lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    turns = torch.empty(B * H * -(-S // 64) * 2, dtype=torch.int32,
                        device=q.device)
    err = _fn("flash_bwd_launch")(
        *_ptrs(q, k, v, o, do, lse, dq, dk, dv, delta, acc, turns), B, S,
        H, D, 1.0 / math.sqrt(D), _build.stream_ptr(q.device))
    _build.check(err, "flash_bwd")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def _route(q, what):
    if q.device.type in ("cuda", "cpu"):
        return q.device.type
    raise RuntimeError(f"{what}: no kernel for device {q.device}")


# ``flash_fwd`` is a ``torch.library`` custom op: its CUDA registration
# launches the kernel (and counts it), its CPU registration is the plain
# version, and its fake one gives the outputs' shapes, so a capture
# (``torch.export``: ``jit.to_static`` / ``jit.save``) records one node
# for it and a replay of the captured graph launches the kernel again.
# The pointer work, the shape checks and the workspaces sit inside the
# CUDA registration, where the tensors are real.

@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    o, lse = _flash_fwd_plain(q, k, v)
    return o.contiguous(), lse.contiguous()


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_op_cuda(q, k, v):
    o, lse = _launch_fwd(q, k, v)
    flash_fwd.launches += 1
    return o, lse


@_flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v):
    if q.device.type == "cuda":
        B, S, H, _ = _check_kernel_args("flash_fwd", q, k, v)
    else:
        B, S, H = q.shape[0], q.shape[1], q.shape[2]
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, S), dtype=torch.float32))


def flash_fwd(q, k, v):
    """Causal attention forward: (o [B, S, H, D], lse [B, H, S] f32)."""
    _route(q, "flash_fwd")
    return _numerics.opaque("flash_fwd", _flash_fwd_op, q, k, v)


def flash_bwd(q, k, v, o, lse, do):
    """Causal attention backward: (dq, dk, dv) from the forward's o and
    lse and the output gradient do."""
    if _route(q, "flash_bwd") == "cuda":
        grads = _numerics.opaque("flash_bwd", _flash_bwd_cuda, q, k, v, o,
                                 lse, do)
        flash_bwd.launches += 1
        return grads
    return _numerics.opaque("flash_bwd", _flash_bwd_plain, q, k, v, o, lse,
                            do)


flash_fwd.launches = 0      # calls that launched the kernels since reset
flash_bwd.launches = 0


class _CausalAttention(torch.autograd.Function):
    """The reference's ``causal_attention`` custom VJP: the forward
    saves q, k, v, o and lse; the backward is ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do)


def causal_attention(q, k, v):
    """Causal self-attention over [B, S, H, D] (q, k, v with the same
    head count), differentiable in all three."""
    return _CausalAttention.apply(q, k, v)
