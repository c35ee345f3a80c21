"""Pipeline parallelism over the ``pp`` axis: GPipe, 1F1B and the
interleaved schedule (the port of ``paddle_tpu/distributed/pipeline.py``).

Each ``pp`` rank holds a contiguous block of the layers (its stage;
``llama.shard_params``) and runs it tick by tick.  A tick's stage
handoff is ``collective.ppermute`` over the ``pp`` group: the
reference's one ``lax.ppermute`` a step.  Where the reference's scan
computes a bubble tick and masks its result, a rank here runs no unit
and moves nothing: both ends of every edge derive whether it carries a
tensor from the same schedule arithmetic, so the units a loop runs are
exactly the schedule's (``distributed.overlap.schedule_events``).

- **GPipe** (``pipeline_forward`` / ``pipeline_loss_fn``): every stage
  runs its layers on microbatch ``t - stage`` at tick ``t``; the
  activation hops by ``ppermute_grad``, so ``backward()`` of the loss
  runs the reverse pipeline with each hop's reverse shift (the
  reference's transpose of the scan).  The last stage keeps the
  outputs and runs the head on them; its loss is summed over ``pp``
  (the other stages add 0), so every rank returns the same value and
  the gradient of its own part.  ``cp_axis`` runs ring attention over
  ``sp`` inside every stage (context parallelism composed with the
  pipeline): each rank holds its block of every microbatch's sequence.
- **1F1B** (``pipeline_1f1b_value_and_grad``): per tick a stage runs one
  forward unit under ``no_grad``, keeping its input in a ring buffer of
  ``BUF`` slots, and one backward unit, which recomputes the stage from
  the kept input and calls ``torch.autograd.backward`` with the
  gradient that arrived (the last stage seeds it from its cross-entropy
  head; stage 0 recomputes the embedding lookup, whose backward adds
  into the embedding's gradient).  The ticks are ``overlap.F_TICK`` /
  ``B_TICK``: lockstep, each tick's two shifts at its end; overlapped,
  the shifts go out at the top of the tick on the last tick's values
  and are waited on only where the next tick consumes them.  Both give
  the same bits.
- **Interleaved** (``pipeline_interleaved_forward`` / ``_loss_fn``):
  ``v`` virtual chunks a rank, global stage ``c * pp + d`` on rank
  ``d``; ``llama.shard_params(..., virtual_pp=v)`` gives rank ``d`` the
  layers of chunks ``d, pp + d, ...`` in that order, so no step moves
  weights.  The hop is the circular shift; backward from autograd.

Under tensor parallelism the stages run tensor parallel with every row
on every ``mp`` rank (no sequence-parallel activations), as the
reference's stage body leaves ``mp`` to GSPMD with no ``sp_axis``.

Under MoE each stage's layers return their aux loss, and the schedules
add it as the reference's do (``pipeline.py:85-95``, ``261-279``,
``415-430``): GPipe sums it over the ticks a stage computes and over
``pp`` and divides by the microbatch count (and averages it over ``sp``
under context parallelism, where each sequence block is routed on its
own); 1F1B adds ``aux_b / n_micro`` per backward unit and seeds its
gradient with ``0.01 / n_micro``; the interleaved schedule sums it over
its units and ``pp`` and does not divide by the microbatch count (the
reference's own scaling, which differs from its other two schedules).
A microbatch's tokens are routed together over the ``dp`` ranks
(``expert_parallel``): each rank's microbatch ``m`` is its share of the
global microbatch ``m`` (``HybridTopology.shard_batch(...,
microbatches=n_micro)``), whose tokens the reference routes together.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..profiler import trace as _trace
from . import collective as C
from .overlap import B_TICK, F_TICK, schedule_constants

__all__ = ["pipeline_forward", "pipeline_loss_fn",
           "pipeline_1f1b_value_and_grad",
           "pipeline_interleaved_forward", "pipeline_interleaved_loss_fn"]


def _stage(topo):
    from .mesh import get_topology
    topo = topo or get_topology()
    return topo, topo.pp_degree, topo.coords["pp"], topo.group("pp")


def _micro(ids, n_micro):
    B = ids.shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"{n_micro} microbatches")
    return ids.reshape(n_micro, B // n_micro, *ids.shape[1:])


class _PPSum(torch.autograd.Function):
    """A scalar summed over ``pp`` (the stages that do not own it add 0),
    so every stage returns the same value; the backward is the identity,
    each stage's gradient of its own part."""

    @staticmethod
    def forward(ctx, x, group):
        return C._all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tie(x, sinks):
    """``x`` plus zero times the sinks: the empty tensors a shift that
    only sends returns, so that their backward (which receives the
    gradient of what they sent) runs."""
    for t in sinks:
        x = x + t.sum()
    return x


def _context(cfg, topo, params, S, cp_axis):
    from ..models import llama
    tp = llama._tensor_parallel(topo, None)
    cp = topo.group(cp_axis) if cp_axis is not None else None
    sin, cos, blk = llama._rope_rows(cfg, S, params["embed"].device, topo,
                                     cp)
    ep = llama._expert_parallel(cfg, topo, False)
    return tp, cp, ep, sin, cos, blk


def _add(acc, a):
    return a if acc is None else acc + a


def pipeline_forward(cfg, topo, n_micro, params, ids, cp_axis=None):
    """ids [B, S] (this rank's rows) -> (h, aux, sinks): GPipe over
    ``pp``.  ``h`` [B, S(/sp), H] is the last stage's output stack (None
    on the other stages); ``aux`` this stage's MoE aux summed over its
    microbatches (None without MoE); ``sinks`` what ``_tie`` must fold
    into the loss.
    ``cp_axis``: shard the sequence over this axis inside the pipeline
    and run ring attention in every stage."""
    from ..models import llama
    topo, pp, s, group = _stage(topo)
    ids = ids.to(params["embed"].device).long()
    tp, cp, ep, sin, cos, blk = _context(cfg, topo, params, ids.shape[1],
                                         cp_axis)
    ids_mb = _micro(ids[:, blk.start:blk.stop], n_micro)
    layers = params["layers"]
    mb, Sl, H = ids_mb.shape[1], ids_mb.shape[2], params["embed"].shape[1]
    tmpl = torch.empty((mb, Sl, H), dtype=params["embed"].dtype,
                       device=params["embed"].device)
    anchor = tmpl.new_empty((0,)).requires_grad_(True)
    outputs: List[torch.Tensor] = []
    sinks: List[torch.Tensor] = []
    state = aux = None
    for t in range(n_micro + pp - 1):
        m = t - s
        active = 0 <= m < n_micro
        y = None
        if active:
            x = llama._embed(cfg, params, ids_mb[m], tp) if s == 0 else state
            y, a = llama.run_layer_stack(cfg, layers, x, sin, cos, tp=tp,
                                         cp=cp, ep=ep)
            if cfg.moe_num_experts:
                aux = _add(aux, a)
            if s == pp - 1:
                outputs.append(y)
        send = active and s < pp - 1
        recv = s > 0 and 0 <= t + 1 - s < n_micro
        state = None
        if send or recv:
            got = C.ppermute_grad(y if send else tmpl, group, 1, send=send,
                                  recv=recv, anchor=anchor)
            if recv:
                state = got
            else:
                sinks.append(got)
    h = torch.cat(outputs) if outputs else None
    return h, aux, sinks


def _head_loss(cfg, params, h, labels, tp):
    """Norm, ``lm_head`` and the cross-entropy of the collected outputs."""
    from ..models import llama
    return llama._ce(llama._logits(cfg, params, h, tp), labels, tp)


def _pipeline_loss(cfg, topo, params, batch, h, aux, sinks, cp_axis):
    """(total, ce) from the last stage's outputs and every stage's aux
    (already scaled as its schedule wants), the same on every rank:
    ``[total, ce]`` is summed over ``pp`` in one call (the stages that
    do not own a term add 0)."""
    from ..models import llama
    topo, pp, s, group = _stage(topo)
    tp = llama._tensor_parallel(topo, None)
    if s == pp - 1:
        labels = batch["labels"]
        if cp_axis is not None:
            blk = topo.sequence_block(labels.shape[1])
            labels = labels[:, blk.start:blk.stop]
        ce = _head_loss(cfg, params, h, labels, tp)
    else:
        ce = params["embed"].new_zeros((), dtype=torch.float32)
    total = ce if aux is None else ce + 0.01 * aux
    both = _PPSum.apply(torch.stack([_tie(total, sinks), ce.detach()]),
                        group)
    if cp_axis is not None:
        both = llama.seq_mean(both, topo.group(cp_axis))
    return both[0], both[1].detach()


def pipeline_loss_fn(cfg, topo, n_micro, params, batch, cp_axis=None):
    """The pipelined loss (``llama.build_train_step``'s GPipe schedule):
    (total, ce), the same value on every rank."""
    h, aux, sinks = pipeline_forward(cfg, topo, n_micro, params,
                                     batch["input_ids"], cp_axis=cp_axis)
    return _pipeline_loss(cfg, topo, params, batch, h,
                          None if aux is None else aux / n_micro, sinks,
                          cp_axis)


# ---------------------------------------------------------------------------
# 1F1B schedule
# ---------------------------------------------------------------------------

def pipeline_1f1b_value_and_grad(cfg, topo, n_micro, params, batch,
                                 overlap=False, *, scale=1.0,
                                 log: Optional[list] = None):
    """Hand-scheduled 1F1B: returns (loss, ce, grads) (the reference's
    ``pipeline.py:120-323``).  ``grads`` has the nesting of ``params``:
    this stage's layer gradients, and the embedding, final norm and head
    gradients summed over ``pp`` (the same on every stage), as are the
    loss and ce.  The gradients are of ``scale`` times the loss (the
    train step's 1/(dp x sharding)).  Saved state a stage: ``BUF``
    microbatch inputs, whatever ``n_micro``.

    ``log``: a list the loop appends its executed units and sends to, in
    ``overlap.schedule_events``' schema; the ranks' logs together are
    that function's events."""
    from ..models import llama
    topo, pp, s, group = _stage(topo)
    _trace.event("pipeline/build", kind="pipeline_build", pp=int(pp),
                 n_micro=int(n_micro), overlap=bool(overlap))
    consts = schedule_constants(pp, n_micro, overlap=overlap)
    T, BUF = consts["T"], consts["BUF"]
    dev = params["embed"].device
    ids = _micro(batch["input_ids"].to(dev).long(), n_micro)
    labels = _micro(batch["labels"].to(dev).long(), n_micro)
    tp, _, ep, sin, cos, _ = _context(cfg, topo, params, ids.shape[2],
                                      None)
    first, last = s == 0, s == pp - 1
    moe = cfg.moe_num_experts > 0
    inv_nm = 1.0 / n_micro
    # leaves of our own: the gradients land in their .grad
    leaves = {k: ({n: t.detach().requires_grad_(True) for n, t in v.items()}
                  if isinstance(v, dict) else v.detach().requires_grad_(True))
              for k, v in params.items()}
    layers = leaves["layers"]
    xs_buf: List[Optional[torch.Tensor]] = [None] * BUF
    mb, S, H = ids.shape[1], ids.shape[2], params["embed"].shape[1]
    tmpl = torch.empty((mb, S, H), dtype=params["embed"].dtype, device=dev)
    # [ce, aux] summed over this stage's units
    sums = torch.zeros((2,), dtype=torch.float32, device=dev)
    # the aux's gradient seed (the reference's 0.01 / n_micro)
    aux_seed = torch.full((), 0.01 * inv_nm * scale, dtype=torch.float32,
                          device=dev)

    def stage(x):
        return llama.run_layer_stack(cfg, layers, x, sin, cos, tp=tp, ep=ep)

    def shifts(y, dx, fm_next, bm_next, async_op):
        """Post this tick's forward and backward shifts: send what this
        stage made, receive what its next units consume."""
        f = C.ppermute(y if y is not None else tmpl, group, 1,
                       send=y is not None and not last,
                       recv=not first and 0 <= fm_next < n_micro,
                       async_op=True)
        b = C.ppermute(dx if dx is not None else tmpl, group, -1,
                       send=dx is not None and not first,
                       recv=not last and 0 <= bm_next < n_micro,
                       async_op=True)
        return (f, b) if async_op else (f.wait(), b.wait())

    def record(kind, t, m):
        if log is None:
            return
        log.append({"kind": kind, "tick": t, "stage": s, "micro": m})
        tf = F_TICK(s, m, overlap=overlap)
        tb = B_TICK(s, m, pp, overlap=overlap)
        if kind == "fwd" and not last:
            log.append({"kind": "send_fwd", "micro": m, "src": s,
                        "dst": s + 1, "tick": tf + 1 if overlap else tf,
                        "produced_tick": tf,
                        "consumed_tick": F_TICK(s + 1, m, overlap=overlap)})
        if kind == "bwd" and not first:
            log.append({"kind": "send_bwd", "micro": m, "src": s,
                        "dst": s - 1, "tick": tb + 1 if overlap else tb,
                        "produced_tick": tb,
                        "consumed_tick": B_TICK(s - 1, m, pp,
                                                overlap=overlap)})

    fwd_in = bwd_in = None            # consumed this tick
    y_prev = dx_prev = None           # overlap: last tick's outputs
    pending = None
    for t in range(T):
        if overlap:
            fm = t - 2 * s
            bm = t - (4 * (pp - 1) + 1 - 2 * s)
            # the shifts go first, on last tick's outputs; they arrive for
            # the units of the next tick
            if pending is not None:
                fwd_in, bwd_in = (w.wait() for w in pending)
            pending = shifts(y_prev, dx_prev, fm + 1, bm + 1, True)
        else:
            fm = t - s
            bm = t - (2 * pp - 1 - s)
        y = dx = None
        # ---- forward unit
        if 0 <= fm < n_micro:
            with torch.no_grad():
                x_in = llama._embed(cfg, leaves, ids[fm], tp) if first \
                    else fwd_in
                y, _ = stage(x_in)
            xs_buf[fm % BUF] = None if first else x_in
            record("fwd", t, fm)
        # ---- backward unit
        if 0 <= bm < n_micro:
            if first:
                x = llama._embed(cfg, leaves, ids[bm], tp)
            else:
                x = xs_buf[bm % BUF].detach().requires_grad_(True)
            xs_buf[bm % BUF] = None
            y_b, aux_b = stage(x)
            if moe:
                sums[1] += aux_b.detach() * inv_nm
            if last:
                ce_m = _head_loss(cfg, leaves, y_b, labels[bm], tp)
                sums[0] += ce_m.detach() * inv_nm
                loss_m = ce_m * (inv_nm * scale)
                if moe:
                    loss_m = loss_m + aux_b * aux_seed
                torch.autograd.backward(loss_m)
            elif moe:
                torch.autograd.backward([y_b, aux_b], [bwd_in, aux_seed])
            else:
                torch.autograd.backward(y_b, bwd_in)
            dx = None if first else x.grad
            record("bwd", t, bm)
        if overlap:
            y_prev, dx_prev = y, dx
        else:
            fwd_in, bwd_in = shifts(y, dx, fm + 1, bm + 1, False)
    if pending is not None:
        for w in pending:
            w.wait()

    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)

    tail = {k: grad(leaves[k]) for k in ("embed", "norm_f", "lm_head")}
    for g in tail.values():
        C._all_reduce(g, group=group)
    C._all_reduce(sums, group=group)
    ce = sums[0]
    grads = dict(tail, layers={k: grad(v) for k, v in layers.items()})
    return (ce + 0.01 * sums[1] if moe else ce), ce, grads


# ---------------------------------------------------------------------------
# interleaved (virtual-stage) schedule
# ---------------------------------------------------------------------------

def pipeline_interleaved_forward(cfg, topo, n_micro, v, params, ids):
    """ids -> (h, aux, sinks) as ``pipeline_forward``, over ``v`` virtual
    chunks a rank (the reference's ``pipeline.py:330-438``): microbatches
    stream in groups of ``pp`` through T = n_micro * v + pp - 1 ticks; at
    tick ``t`` rank ``d`` runs work ``r = t - d``, i.e. chunk ``(r % (v
    pp)) // pp`` of microbatch ``(r // (v pp)) pp + r % pp``, on the
    input rank ``d - 1`` made the tick before (rank 0 from rank pp - 1,
    or the embedding for chunk 0).  ``params["layers"]`` holds this rank's
    chunks in order (``llama.shard_params(..., virtual_pp=v)``)."""
    from ..models import llama
    topo, pp, d, group = _stage(topo)
    if n_micro % pp:
        raise ValueError(f"the interleaved schedule streams microbatches "
                         f"in groups of pp={pp}; n_micro={n_micro}")
    ids = ids.to(params["embed"].device).long()
    tp, _, ep, sin, cos, _ = _context(cfg, topo, params, ids.shape[1],
                                      None)
    ids_mb = _micro(ids, n_micro)
    L = next(iter(params["layers"].values())).shape[0]
    if L % v:
        raise ValueError(f"{L} layers a rank do not split into {v} chunks")
    chunks = [{k: t[c * (L // v):(c + 1) * (L // v)]
               for k, t in params["layers"].items()} for c in range(v)]
    mb, S, H = ids_mb.shape[1], ids_mb.shape[2], params["embed"].shape[1]
    tmpl = torch.empty((mb, S, H), dtype=params["embed"].dtype,
                       device=params["embed"].device)
    anchor = tmpl.new_empty((0,)).requires_grad_(True)
    work = n_micro * v

    def unit(r):
        """(chunk, microbatch) of work index ``r``, or None."""
        if not 0 <= r < work:
            return None
        return (r % (v * pp)) // pp, (r // (v * pp)) * pp + r % pp

    outputs: Dict[int, torch.Tensor] = {}
    sinks: List[torch.Tensor] = []
    state = aux = None
    for t in range(work + pp - 1):
        u = unit(t - d)
        y = None
        if u is not None:
            c, m = u
            x = llama._embed(cfg, params, ids_mb[m], tp) \
                if d == 0 and c == 0 else state
            y, a = llama.run_layer_stack(cfg, chunks[c], x, sin, cos, tp=tp,
                                         ep=ep)
            if cfg.moe_num_experts:
                aux = _add(aux, a)
            if d == pp - 1 and c == v - 1:
                outputs[m] = y
        # the hop d -> d + 1 (mod pp) carries y unless it left the last
        # chunk; this rank's next unit takes what arrives unless it is an
        # entry (chunk 0 on rank 0)
        send = u is not None and not (d == pp - 1 and u[0] == v - 1)
        nxt = unit(t + 1 - d)
        recv = nxt is not None and not (d == 0 and nxt[0] == 0)
        state = None
        if send or recv:
            got = C.ppermute_grad(y if send else tmpl, group, 1, send=send,
                                  recv=recv, anchor=anchor)
            if recv:
                state = got
            else:
                sinks.append(got)
    h = torch.cat([outputs[m] for m in range(n_micro)]) if outputs else None
    return h, aux, sinks


def pipeline_interleaved_loss_fn(cfg, topo, n_micro, v, params, batch):
    """The interleaved schedule's loss (``build_train_step`` schedule
    ``"interleaved"``): (total, ce), the same value on every rank.  The
    aux is not divided by the microbatch count (the reference's
    ``pipeline.py:415-430``)."""
    h, aux, sinks = pipeline_interleaved_forward(cfg, topo, n_micro, v,
                                                 params, batch["input_ids"])
    return _pipeline_loss(cfg, topo, params, batch, h, aux, sinks, None)
