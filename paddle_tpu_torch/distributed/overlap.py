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
(a dict's keys sorted, as JAX flattens it).

The reference's schedule helpers (``F_TICK`` ... ``measured_overlap``)
come with the pipeline (ROADMAP A2).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import collective as C

__all__ = ["Reducer", "reduce_in_backward", "reduce_tree_in_backward",
           "bucketed_psum"]


class Reducer:
    """The asynchronous all-reduces one backward pass started over
    ``group``."""

    def __init__(self, group):
        self.group = group
        self.pending: List = []

    def start(self, g: torch.Tensor):
        self.pending.append(C.all_reduce(g, group=self.group,
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


def bucketed_psum(tree, group, bucket_bytes: int = 4 << 20):
    """Sum a tree of tensors over ``group`` in buckets of at most
    ``bucket_bytes`` (a leaf larger than that is a bucket of its own),
    leaves in sorted-key order; returns the same nesting of reduced
    tensors.  Each bucket is one all-reduce of its leaves flattened into
    one buffer (a bucket of one leaf reduces a copy of it)."""
    leaves = list(_flatten(tree))
    if not leaves:
        return tree
    buckets: List[List[int]] = [[]]
    acc = 0
    for i, (_, leaf) in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        last = buckets[-1]
        if last and (acc + nbytes > bucket_bytes
                     or leaf.dtype != leaves[last[0]][1].dtype):
            buckets.append([])
            acc = 0
        buckets[-1].append(i)
        acc += nbytes
    out = {}
    for idxs in buckets:
        parts = [leaves[i][1] for i in idxs]
        flat = torch.cat([p.reshape(-1) for p in parts])
        C.all_reduce(flat, group=group)
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
