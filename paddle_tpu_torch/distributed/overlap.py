"""Gradient reduction overlapped with the backward pass (the port of
``paddle_tpu/distributed/overlap.py:50-123``).

``reduce_in_backward`` is the identity forward; in the backward it
starts an asynchronous all-reduce of the gradient and hands autograd the
buffer being reduced.  Hooked on the per-layer parameter slices that
``run_layer_stack``'s ``unbind`` hands each layer, it starts one
reduction per layer and leaf while the layers below are still in their
backward.  Nothing reads those buffers until the ``unbind``'s backward
stacks them into the layer leaves' gradients, and ``Reducer.wait_all``
runs just before that: so the compute stream (or the CPU) waits for
the reductions once, after the last layer's backward was issued, and
not once a layer.

``bucketed_psum`` reduces the tail (``embed``, ``norm_f``,
``lm_head``) in buckets of at most 4 MiB, in the reference's leaf order
(a dict's keys sorted, as JAX flattens it).  ``plan_buckets`` is its
grouping, which ``parallel.DataParallel`` shares.

The 1F1B schedule arithmetic (``F_TICK``, ``B_TICK``,
``schedule_constants``) and its static event model (``schedule_events``,
``transfer_stats``, ``overlap_fraction``, ``measured_overlap``) are the
port's copy of the reference's (``overlap.py:125-233``, pure Python):
``pipeline.pipeline_1f1b_value_and_grad`` runs its units at these ticks,
so the simulator and the loop cannot drift apart.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from . import collective as C

__all__ = ["Reducer", "reduce_in_backward", "reduce_tree_in_backward",
           "plan_buckets", "bucketed_psum", "F_TICK", "B_TICK",
           "schedule_constants", "schedule_events", "transfer_stats",
           "overlap_fraction", "measured_overlap"]


class Reducer:
    """The asynchronous all-reduces one backward pass started over
    ``group``."""

    def __init__(self, group):
        self.group = group
        self.pending: List = []

    def start(self, g: torch.Tensor):
        self.pending.append(C._all_reduce(g, group=self.group,
                                         async_op=True))

    def wait_all(self, *_):
        """Order everything after the reductions started so far (an
        autograd pre-hook: its arguments are ignored)."""
        for work in self.pending:
            work.wait()
        self.pending.clear()


class _ReduceInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reducer):
        ctx.reducer = reducer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a buffer of our own: the reduction writes it in place
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.reducer.start(g)
        return g, None


def reduce_in_backward(x: torch.Tensor, reducer: Reducer) -> torch.Tensor:
    """Identity forward; the backward starts ``reducer``'s all-reduce of
    the gradient.  Whoever reads the gradient calls
    ``reducer.wait_all()`` first."""
    return _ReduceInBackward.apply(x, reducer)


def reduce_tree_in_backward(tree: Dict[str, torch.Tensor],
                            reducer: Reducer) -> Dict[str, torch.Tensor]:
    """``reduce_in_backward`` on every leaf of a flat dict."""
    return {k: reduce_in_backward(v, reducer) for k, v in tree.items()}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def plan_buckets(tensors, bucket_bytes: int,
                 first_bytes: Optional[int] = None) -> List[List[int]]:
    """The indices of ``tensors`` grouped into buckets, in order: a
    bucket closes before the tensor that would take it past
    ``bucket_bytes`` (the first bucket past ``first_bytes``, when given)
    or that has another dtype; a tensor larger than the limit is a
    bucket of its own."""
    buckets: List[List[int]] = [[]]
    acc = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        last = buckets[-1]
        limit = (first_bytes if first_bytes is not None
                 and len(buckets) == 1 else bucket_bytes)
        if last and (acc + nbytes > limit
                     or t.dtype != tensors[last[0]].dtype):
            buckets.append([])
            acc = 0
        buckets[-1].append(i)
        acc += nbytes
    return buckets


def bucketed_psum(tree, group, bucket_bytes: int = 4 << 20):
    """Sum a tree of tensors over ``group`` in buckets of at most
    ``bucket_bytes`` (a leaf larger than that is a bucket of its own),
    leaves in sorted-key order; returns the same nesting of reduced
    tensors.  Each bucket is one all-reduce of its leaves flattened into
    one buffer (a bucket of one leaf reduces a copy of it)."""
    leaves = list(_flatten(tree))
    if not leaves:
        return tree
    out = {}
    for idxs in plan_buckets([leaf for _, leaf in leaves], bucket_bytes):
        parts = [leaves[i][1] for i in idxs]
        flat = torch.cat([p.reshape(-1) for p in parts])
        C._all_reduce(flat, group=group)
        for i, piece in zip(idxs, flat.split([p.numel() for p in parts])):
            out[leaves[i][0]] = piece.view(leaves[i][1].shape)
    return _unflatten(out) if isinstance(tree, dict) else out[()]


def _unflatten(flat):
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# 1F1B schedule arithmetic + static event model
# ---------------------------------------------------------------------------

def F_TICK(stage: int, micro: int, *, overlap: bool) -> int:
    """Tick at which stage ``stage`` runs the forward of microbatch
    ``micro``. Lockstep: s + m (handoffs consumed on the very next
    tick). Overlapped: 2s + m — one extra tick of pipeline depth per
    stage buys every edge transfer a full tick of slack."""
    return (2 * stage if overlap else stage) + micro


def B_TICK(stage: int, micro: int, pp: int, *, overlap: bool) -> int:
    """Tick of the backward unit B(stage, micro). Lockstep:
    2*pp - 1 - s + m. Overlapped: 4*(pp-1) + 1 - 2s + m (the last
    stage's backward still starts one tick after its forward)."""
    if overlap:
        return 4 * (pp - 1) + 1 - 2 * stage + micro
    return 2 * pp - 1 - stage + micro


def schedule_constants(pp: int, n_micro: int, *,
                       overlap: bool) -> Dict[str, int]:
    """(T, BUF) of the tick loop: total ticks and the stage-input
    ring-buffer depth. These are the same expressions
    ``pipeline.pipeline_1f1b_value_and_grad`` uses — the simulator and
    the loop cannot drift apart."""
    if overlap:
        # last backward: B(0, n_micro-1) at 4*(pp-1)+1 + n_micro-1
        return {"T": n_micro + 4 * pp - 3, "BUF": 4 * pp}
    return {"T": n_micro + 2 * pp - 1, "BUF": 2 * pp}


def schedule_events(pp: int, n_micro: int, *, overlap: bool,
                    log: Optional[list] = None) -> List[Dict[str, Any]]:
    """Static event log of one 1F1B batch.

    Events (dicts) come in two kinds:
      compute  — {"kind": "fwd"|"bwd", "tick", "stage", "micro"}
      transfer — {"kind": "send_fwd"|"send_bwd", "tick", "src", "dst",
                  "micro", "produced_tick", "consumed_tick"}

    ``log`` is injectable: callers (tests) pass their own list and the
    function appends into it, so schedule-ordering assertions run
    against exactly what the model emitted. Returns the log either way.
    """
    if pp < 1 or n_micro < 1:
        raise ValueError(f"need pp >= 1 and n_micro >= 1, "
                         f"got pp={pp}, n_micro={n_micro}")
    events = log if log is not None else []
    for m in range(n_micro):
        for s in range(pp):
            tf = F_TICK(s, m, overlap=overlap)
            tb = B_TICK(s, m, pp, overlap=overlap)
            events.append({"kind": "fwd", "tick": tf, "stage": s,
                           "micro": m})
            events.append({"kind": "bwd", "tick": tb, "stage": s,
                           "micro": m})
            if s < pp - 1:
                # forward edge s -> s+1: consumed at F(s+1, m)
                consumed = F_TICK(s + 1, m, overlap=overlap)
                events.append({
                    "kind": "send_fwd", "micro": m, "src": s, "dst": s + 1,
                    "tick": tf + 1 if overlap else tf,
                    "produced_tick": tf, "consumed_tick": consumed})
            if s > 0:
                # backward edge s -> s-1: consumed at B(s-1, m)
                consumed = B_TICK(s - 1, m, pp, overlap=overlap)
                events.append({
                    "kind": "send_bwd", "micro": m, "src": s, "dst": s - 1,
                    "tick": tb + 1 if overlap else tb,
                    "produced_tick": tb, "consumed_tick": consumed})
    events.sort(key=lambda e: (e["tick"], e["stage"] if "stage" in e
                               else e["src"]))
    return events


def transfer_stats(events) -> Dict[str, int]:
    """Count stage-boundary transfers and how many are *serialized*: the
    consuming compute runs on the tick right after the producing compute,
    so the wire sits on the critical path (compute -> transfer ->
    compute with zero slack). A transfer with >= 2 ticks between
    producer and consumer has a full tick to ride under compute."""
    total = serialized = 0
    for e in events:
        if e["kind"] not in ("send_fwd", "send_bwd"):
            continue
        total += 1
        if e["consumed_tick"] - e["produced_tick"] < 2:
            serialized += 1
    return {"total_transfers": total, "serialized_transfers": serialized}


def overlap_fraction(events) -> float:
    """Fraction of stage-boundary transfers hidden under compute (1.0 =
    every edge has a free tick; 0.0 = every edge serializes a tick)."""
    st = transfer_stats(events)
    if st["total_transfers"] == 0:
        return 1.0
    return 1.0 - st["serialized_transfers"] / st["total_transfers"]


def measured_overlap(events) -> Dict[str, Any]:
    """Overlap report for a *recorded* schedule: feed it the event list
    ``profiler.trace.pipeline_schedule_events()`` returns (the flight
    recorder stores each scheduled unit verbatim in this module's event
    schema) and the exact simulator rules above score it — so a measured
    trace and ``schedule_events`` for the same (pp, n_micro, overlap)
    agree bit-for-bit, ordering included."""
    events = list(events)
    return {"transfer_stats": transfer_stats(events),
            "overlap_fraction": overlap_fraction(events),
            "n_events": len(events)}
