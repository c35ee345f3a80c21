"""Long-context sequence/context parallelism: ring attention and Ulysses
(the port of ``paddle_tpu/distributed/sequence_parallel.py``).

- **Ring attention** (context parallel): q/k/v hold this rank's block of
  the sequence; the k/v blocks rotate around the ranks of the axis by
  ``collective.ppermute_grad`` while each rank merges its q block's
  attention over every block with an online softmax.  Exact (causal)
  attention at O(S/n) memory a rank.  Under GQA only the nkv heads
  rotate; they are expanded at use.
- **Ulysses**: ``all_to_all`` reshards [B, S/n, H, D] to [B, S, H/n, D],
  full attention runs on the rank's heads, and a second ``all_to_all``
  reshards back.

Both are plain PyTorch in float32 (``torch.einsum``), as the reference
computes them in ``jnp`` outside any Pallas kernel, with their backward
from autograd: the ring's from the reverse shifts of ``ppermute_grad``,
Ulysses' from the reverse ``all_to_all``.  Every rank of the axis
computes every block, fully masked ones included, so every rank runs
the same shifts in the same order forward and backward.

``ring_attention`` / ``ulysses_attention`` take the axis (an axis name,
a tuple of them, or a group) and the rank's blocks; the
``*_sharded`` wrappers take global [B, S, H, D] tensors on every rank,
run on this rank's block of the sequence and return the global result.
"""
from __future__ import annotations

import math

import torch

from . import collective as C

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_sharded",
           "ulysses_attention_sharded"]


def _block_attn(q, k, v, scale, q_off, k_off, causal):
    """Blockwise attention stats for the online-softmax merge.

    q: [B, Sq, H, D], k/v: [B, Sk, Hkv, D]; returns (m, l, acc) with m, l
    [B, H, Sq] float32 and acc [B, H, Sq, D] float32 (not normalized).
    q_off/k_off: the blocks' absolute offsets for the causal mask."""
    if k.shape[2] != q.shape[2]:
        # GQA: expand kv heads at use only (the ring rotates nkv heads)
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt = q.transpose(1, 2).float()                   # [B, H, Sq, D]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        q_pos = q_off + torch.arange(Sq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, -math.inf)
    m = s.amax(dim=-1)                               # [B, H, Sq]
    # fully masked rows: keep m finite so exp() is well defined
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, vt)
    return m_safe, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    """Merge two online-softmax partial results."""
    m = torch.maximum(m1, m2)
    c1 = torch.where(l1 > 0, torch.exp(m1 - m), 0.0)
    c2 = torch.where(l2 > 0, torch.exp(m2 - m), 0.0)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def ring_attention(q, k, v, axis="sp", causal: bool = True):
    """Exact (causal) attention with the sequence split over ``axis``:
    q/k/v are this rank's [B, S/n, H(kv), D] blocks, block ``i`` of the
    sequence on the axis' rank ``i``.  The k/v blocks take n - 1 shifts
    around the ring (the reference's n-th rotation is never read, so it
    is not made); returns this rank's [B, S/n, H, D] output in q's
    dtype."""
    n, idx = C.group_rank(axis)
    B, Sl, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q_off = idx * Sl
    m = torch.full((B, H, Sl), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for i in range(n):
        # the block held now arrived from rank (idx - i) mod n
        src = (idx - i) % n
        bm, bl, bacc = _block_attn(q, kc, vc, scale, q_off, src * Sl,
                                   causal)
        m, l, acc = _merge(m, l, acc, bm, bl, bacc)
        if i < n - 1:
            kc = C.ppermute_grad(kc, axis, 1)
            vc = C.ppermute_grad(vc, axis, 1)
    out = acc / l.clamp_min(1e-38)[..., None]
    return out.transpose(1, 2).to(q.dtype)          # [B, S/n, H, D]


class _AllToAll(torch.autograd.Function):
    """Split ``x`` along ``split`` into one block a rank and concatenate
    what arrives along ``concat`` in rank order (the reference's tiled
    ``lax.all_to_all``); the backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.args = (axis, split, concat)
        return _all_to_all(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        axis, split, concat = ctx.args
        return _all_to_all(g, axis, concat, split), None, None, None


def _all_to_all(x, axis, split, concat):
    n, _ = C.group_rank(axis)
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    parts = torch.stack(x.chunk(n, dim=split))       # [n, ...]
    got = C._all_to_all(parts, group=axis)
    return torch.cat(got.unbind(0), dim=concat)


def ulysses_attention(q, k, v, axis="sp", causal: bool = True,
                      attn_fn=None):
    """Ulysses sequence parallelism: [B, S/n, H, D] blocks to
    [B, S, H/n, D] by ``all_to_all``, attention over the whole sequence
    on this rank's heads (``attn_fn(q, k, v)``, else the plain float32
    attention), and back.  H must divide by n."""
    n, _ = C.group_rank(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads {H} not divisible by sp degree {n}")

    def to_heads(x):        # [B, S/n, H, D] -> [B, S, H/n, D]
        return _AllToAll.apply(x, axis, 2, 1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if attn_fn is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
        _, l, acc = _block_attn(qh, kh, vh, scale, 0, 0, causal)
        out = acc / l.clamp_min(1e-38)[..., None]
        out = out.transpose(1, 2).to(q.dtype)
    else:
        out = attn_fn(qh, kh, vh)
    return _AllToAll.apply(out, axis, 1, 2)          # [B, S/n, H, D]


class _GatherSeq(torch.autograd.Function):
    """All-gather the sequence blocks into the global tensor every rank
    holds; the backward keeps this rank's block of the gradient (each
    rank's gradient of a replicated result is the whole one)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.args = (axis, x.shape[1])
        return C._all_gather(x, axis, dim=1)

    @staticmethod
    def backward(ctx, g):
        axis, sl = ctx.args
        _, idx = C.group_rank(axis)
        return g[:, idx * sl:(idx + 1) * sl], None


def _sharded(fn, q, k, v, axis):
    n, idx = C.group_rank(axis)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence {S} does not split over {n} ranks")
    blk = slice(idx * S // n, (idx + 1) * S // n)
    out = fn(q[:, blk], k[:, blk], v[:, blk])
    return _GatherSeq.apply(out, axis)


def ring_attention_sharded(q, k, v, axis="sp", causal: bool = True):
    """Global [B, S, H, D] q/k/v on every rank: ring attention on this
    rank's block of the sequence, the global output returned."""
    return _sharded(lambda a, b, c: ring_attention(a, b, c, axis, causal),
                    q, k, v, axis)


def ulysses_attention_sharded(q, k, v, axis="sp", causal: bool = True):
    return _sharded(lambda a, b, c: ulysses_attention(a, b, c, axis,
                                                      causal),
                    q, k, v, axis)
