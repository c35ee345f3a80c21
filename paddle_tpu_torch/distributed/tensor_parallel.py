"""Tensor parallelism over the ``mp`` axis, written out (the reference
gets it from GSPMD and ``llama.param_specs``).

A layer's column-parallel products (``wq``/``wk``/``wv``,
``w_gate``/``w_up``, ``lm_head``) take their input through ``enter`` and
its row-parallel products (``wo``/``w_down``) hand their partial sums to
``leave``: Megatron's ``f``/``g`` pair, as ``torch.autograd.Function``s.

- Without sequence parallelism, ``enter`` is the identity forward and an
  all-reduce of the gradient backward; ``leave`` all-reduces forward and
  is the identity backward.  Every rank holds every row.
- With sequence parallelism (``sp``, the reference's ``sp_axis="mp"``)
  the activations between the blocks hold S/mp rows of the sequence:
  ``enter`` all-gathers them along the sequence forward and
  reduce-scatters the gradient backward; ``leave`` reduce-scatters the
  partial sums forward and all-gathers the gradient backward.  Norms and
  residuals then run on S/mp rows.

``embedding`` is the vocab-parallel lookup (rows outside this rank's
vocab block are zero, then ``leave``); ``cross_entropy`` the
vocab-parallel logsumexp cross-entropy over ``[B, S, V/mp]`` logits
(max and sum all-reduces, the target logit from its owner), so no rank
builds the full logits.  ``gather`` makes a column-parallel output
whole (all-gather forward, this rank's block of the gradient backward);
``split`` is its inverse, for a row-parallel product whose input is
whole.  Both take any group record of ``TensorParallel``'s shape.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import collective as C

__all__ = ["TensorParallel", "enter", "leave", "gather", "split",
           "embedding", "cross_entropy"]

SEQ = 1   # the sequence dim of [B, S, ...] activations


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's place in its ``mp`` group."""
    group: dist.ProcessGroup
    size: int
    rank: int
    sp: bool


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        if tp.sp:
            return C._all_gather(x, tp.group, dim=SEQ)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if tp.sp:
            return C._reduce_scatter(g, group=tp.group, dim=SEQ), None
        return C._all_reduce(g.clone(memory_format=torch.contiguous_format),
                            group=tp.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        if tp.sp:
            return C._reduce_scatter(x, group=tp.group, dim=SEQ)
        # a copy: the product's output may be what the "dots" remat
        # policy keeps
        return C._all_reduce(x.clone(memory_format=torch.contiguous_format),
                            group=tp.group)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if tp.sp:
            return C._all_gather(g, tp.group, dim=SEQ), None
        return g, None


def enter(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Into a column-parallel product: every row of the sequence."""
    return _Enter.apply(x, tp)


def leave(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Out of a row-parallel product: the sum over the group (of this
    rank's rows under ``sp``)."""
    return _Leave.apply(x, tp)


class _Gather(torch.autograd.Function):
    """All-gather ``dim`` over the group forward; backward keeps this
    rank's block of the gradient (what follows runs the same on every
    rank of the group, so the gradient is the same too)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim % x.dim()
        return C._all_gather(x.contiguous(), tp.group, dim=ctx.dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.tp.size
        return g.narrow(ctx.dim, ctx.tp.rank * n, n).contiguous(), None, \
            None


class _Split(torch.autograd.Function):
    """This rank's block of ``dim`` forward; the gradient blocks
    all-gathered backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim % x.dim()
        n = x.shape[ctx.dim] // tp.size
        return x.narrow(ctx.dim, tp.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return C._all_gather(g.contiguous(), ctx.tp.group,
                            dim=ctx.dim), None, None


def gather(x: torch.Tensor, tp: TensorParallel, dim: int = -1
           ) -> torch.Tensor:
    """The group's blocks of ``x`` made whole along ``dim`` (a
    column-parallel output along its last dim)."""
    return _Gather.apply(x, tp, dim)


def split(x: torch.Tensor, tp: TensorParallel, dim: int = -1
          ) -> torch.Tensor:
    """This rank's block of ``dim`` of a whole input (``gather``'s
    inverse)."""
    return _Split.apply(x, tp, dim)


def embedding(ids: torch.Tensor, embed: torch.Tensor,
              tp: TensorParallel) -> torch.Tensor:
    """Vocab-parallel lookup: ``embed`` is this rank's [V/mp, H] block
    of rows; ids outside it look up zeros, and ``leave`` sums the
    group's lookups."""
    lo = tp.rank * embed.shape[0]
    local = ids - lo
    mine = (local >= 0) & (local < embed.shape[0])
    x = F.embedding(torch.where(mine, local, 0), embed)
    x = x * mine[..., None].to(x.dtype)
    return leave(x, tp)


class _CrossEntropy(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over logits split
    by vocab blocks across the group."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        v = logits.shape[-1]
        lo = tp.rank * v
        m = logits.amax(dim=-1)
        C._all_reduce(m, op=C.ReduceOp.MAX, group=tp.group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        local = labels - lo
        mine = (local >= 0) & (local < v)
        idx = torch.where(mine, local, 0)
        tgt = logits.gather(-1, idx[..., None])[..., 0] * mine.to(
            logits.dtype)
        C._all_reduce(s, group=tp.group)
        C._all_reduce(tgt, group=tp.group)
        # e becomes the softmax in place: what the backward needs
        e.div_(s[..., None])
        ctx.save_for_backward(e, idx, mine)
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -(g * mine.to(g.dtype))[..., None])
        return grad, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  tp: TensorParallel) -> torch.Tensor:
    """Per-token cross-entropy [B, S] from this rank's [B, S, V/mp]
    block of the logits (float32)."""
    return _CrossEntropy.apply(logits, labels, tp)
