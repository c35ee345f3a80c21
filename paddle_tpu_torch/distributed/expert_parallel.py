"""Expert parallelism over ``dp`` for the MoE layer (the reference gets it
from GSPMD: ``param_specs`` splits the expert axis of ``w_gate``,
``w_up`` and ``w_down`` over ``dp``, and ``_moe_mlp`` runs on the global
batch, paddle_tpu/models/llama.py:178-183, 362-402).

Here each rank runs on its own rows, so ``models.llama._moe_mlp`` calls
this module to compute what the reference computes on the global
batch:

- **Capacity.**  ``C = max(1, int(cf * T * K / E))`` counts the tokens
  of every rank whose tokens share the experts' buffers: the batch
  ranks (``dp`` x ``sharding``), and the ``sp`` ranks under context
  parallelism outside the pipeline (``ExpertParallel.n_tokens``).
- **Slots.**  A token's slot in its expert's buffer is the number of
  ``(token, k)`` assignments to that expert before it in the global
  order.  That order is the reference's ``t = b * S + s`` over the
  global batch: the batch ranks' contiguous blocks of rows
  (``HybridTopology.shard_batch``), and within a row the ``sp`` ranks'
  blocks of the sequence.  ``slot_offsets`` gathers each rank's
  per-row counts and hands every (row, sequence block) the exclusive
  prefix sum of the counts before it.
- **Dispatch and combine.**  Each rank scatters its tokens into a full
  ``[E, C, H]`` buffer at their global slots (zeros elsewhere);
  ``dispatch`` reduce-scatters it over ``dp`` along the expert axis and
  sums it over the ranks that hold the same experts with other tokens
  (``sharding``, and ``sp`` in the token order), so each rank holds
  every token of its ``E/dp`` experts; ``combine`` all-gathers the
  experts' outputs over ``dp``.  Both are autograd functions whose
  backward is the other collective.
- **Aux.**  ``token_sum`` all-reduces the router's per-expert sums over
  the token ranks.  Every rank's loss then holds the whole aux and is
  weighted as a share of the global loss, so the backward all-reduces
  the gradient too (the sum of the ranks' seeds) and scales it by
  ``grad_scale``: 1 / (sequence blocks x ``mp``), the ranks whose
  shares of the aux gradient the train step sums again.

An expert leaf's gradient on a rank then holds every token of the rank's
``dp`` slice for its experts: the train step sums it over ``sharding``
and ``sp`` only, never over ``dp`` (``distributed.zero``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import collective as C
from .mesh import ONE_RANK

__all__ = ["ExpertParallel", "expert_parallel", "slot_offsets",
           "dispatch", "combine", "token_sum"]


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """One rank's place among the ranks whose tokens share the experts.

    ``ep`` is the ``dp`` group the experts split over (``ep_size`` ranks,
    this one ``ep_rank``); ``rep`` the ranks that hold the same experts
    with other tokens; ``tokens`` every rank whose tokens share the
    buffers, in the global token order (batch index major, then the
    sequence block), ``n_batch`` x ``n_seq`` of them, this rank at
    (``batch_index``, ``seq_index``)."""
    ep: object
    ep_size: int
    ep_rank: int
    rep: object
    tokens: object
    n_batch: int
    n_seq: int
    batch_index: int
    seq_index: int

    @property
    def n_tokens(self) -> int:
        return self.n_batch * self.n_seq


def expert_parallel(topo, seq: bool = False) -> Optional[ExpertParallel]:
    """The expert-parallel context of ``topo`` (None when this rank's
    tokens share the buffers with no other rank).  ``seq``: the ``sp``
    ranks' sequence blocks are in the token order (context parallelism
    outside the pipeline; the pipeline's context parallelism routes each
    sequence block on its own, as the reference's ``cp_axis_level``)."""
    if topo is None:
        return None
    batch = topo.batch_axes
    batch = (batch,) if isinstance(batch, str) else tuple(batch)
    n_seq = topo.sp_degree if seq else 1
    tok_axes = batch + (("sp",) if seq else ())
    if topo.axis_size(tok_axes) == 1:
        return None
    rep_axes = tuple(a for a in tok_axes if a != "dp")
    return ExpertParallel(
        ep=topo.group("dp"), ep_size=topo.dp_degree,
        ep_rank=topo.coords["dp"], rep=topo.group(rep_axes),
        tokens=topo.group(tok_axes), n_batch=topo.axis_size(batch),
        n_seq=n_seq, batch_index=topo.axis_index(batch),
        seq_index=topo.coords["sp"] if seq else 0)


def slot_offsets(counts: torch.Tensor,
                 ep: Optional[ExpertParallel]) -> torch.Tensor:
    """counts [B, E] (this rank's ``(token, k)`` assignments to each
    expert, by local row) -> offsets [B, E]: the assignments to each
    expert before each local row's block of tokens in the global
    order."""
    B, E = counts.shape
    if ep is None:
        return counts.cumsum(0) - counts
    # [n_batch * n_seq * B, E] in the token group's rank order
    every = C._all_gather(counts, ep.tokens)
    seg = every.view(ep.n_batch, ep.n_seq, B, E).transpose(1, 2)
    seg = seg.reshape(-1, E)
    before = (seg.cumsum(0) - seg).view(ep.n_batch, B, ep.n_seq, E)
    return before[ep.batch_index, :, ep.seq_index]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` into a new tensor (``t`` itself over
    one rank)."""
    if C.resolve_group(group) is None:
        return t
    return C._all_reduce(t.clone(memory_format=torch.contiguous_format),
                        group=group)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, ep):
        ctx.ep = ep
        return _summed(C._reduce_scatter(buf, group=ep.ep, dim=0), ep.rep)

    @staticmethod
    def backward(ctx, g):
        ep = ctx.ep
        return C._all_gather(_summed(g, ep.rep), ep.ep, dim=0), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, ep):
        ctx.ep = ep
        return C._all_gather(out.contiguous(), ep.ep, dim=0)

    @staticmethod
    def backward(ctx, g):
        return C._reduce_scatter(g.contiguous(), group=ctx.ep.ep,
                                dim=0), None


def dispatch(buf: torch.Tensor, ep: ExpertParallel) -> torch.Tensor:
    """[E, C, H] (this rank's tokens at their global slots) -> [E/dp, C,
    H]: every token of this rank's experts."""
    return _Dispatch.apply(buf, ep)


def combine(out: torch.Tensor, ep: ExpertParallel) -> torch.Tensor:
    """[E/dp, C, H] (this rank's experts' outputs) -> [E, C, H]."""
    return _Combine.apply(out, ep)


class _TokenSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.group, ctx.grad_scale = group, grad_scale
        return _summed(x, group).clone()

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group) * ctx.grad_scale, None, None


def token_sum(x: torch.Tensor, ep: Optional[ExpertParallel],
              grad_scale: float = 1.0) -> torch.Tensor:
    """``x`` summed over the token ranks; the backward sums the ranks'
    gradients and scales them by ``grad_scale`` (module docstring)."""
    group = ONE_RANK if ep is None else ep.tokens
    if group is ONE_RANK and grad_scale == 1.0:
        return x
    return _TokenSum.apply(x, group, grad_scale)
