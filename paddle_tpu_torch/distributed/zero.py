"""ZeRO-1: optimizer states sharded over the zero axis (the port of the
reference's ``zero_shard_spec``, ``paddle_tpu/models/llama.py:922-937``).

The zero axis is ``sharding`` when the topology carves one out, else
``dp``.  Each leaf's state shard is the reference's choice: the largest
dimension not already split (by ``mp``) whose global size divides by the
zero degree, the lower index on a tie, so every rank's state has
exactly the shape of the JAX state leaf's ``sharding.shard_shape``.  A
leaf with no such dimension, or every leaf under ``zero=False``, keeps
its whole state on every rank.

A step reduce-scatters each sharded leaf's gradient over the zero axis
(then sums it over the rest of the batch axes), runs the optimizer on
this rank's block of the parameter (in place: a view, so no copy of the
weights is kept), and all-gathers the parameter back; an unsharded leaf's
gradient is all-reduced over the batch axes and the optimizer updates
the parameter itself.  A leaf split over a batch axis (an MoE expert
leaf, split over ``dp``) already holds the gradient of every token of
its slice of that axis: its sums leave the axis out.  The optimizer is
any ``torch.optim`` optimizer a factory builds over the tensors it is
handed.

Checkpoints key the optimizer's state by parameter path, not by tensor:
``state_tree()`` is this rank's state (moments and step counters) by
path, ``full_state_tree()`` the same with every ZeRO block gathered
(collective over the zero axis), and ``load_state_tree`` takes either
form back, cutting this rank's block where the state is sharded.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import collective as C

__all__ = ["zero_axis", "zero_shard_dim", "ZeroOptimizer"]


def zero_axis(topo) -> str:
    return "sharding" if topo.dims["sharding"] > 1 else "dp"


def zero_shard_dim(spec: Sequence[Optional[str]], shape: Sequence[int],
                   axis: str, degree: int) -> Optional[int]:
    """The dimension of a leaf of global ``shape`` placed by ``spec``
    (one axis name or None a dimension) that its optimizer state splits
    over ``axis`` of ``degree`` ranks, or None."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    if axis in dims or not shape:
        return None
    for i, d in sorted(enumerate(shape), key=lambda t: -t[1]):
        if dims[i] is None and d % degree == 0 and d >= degree:
            return i
    return None


class ZeroOptimizer:
    """The optimizer state of one rank (``build_train_step``'s
    ``opt_state``).

    ``params``: this rank's parameters by path (its ``mp`` and ``pp``
    shards, in the order the optimizer takes them); ``specs``: each
    path's placement.  Under context parallelism (sp > 1) each rank's
    gradients are partial sums over ``sp`` too, and are summed over it
    with the batch axes."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 specs: Dict[str, Tuple], topo,
                 make_optimizer: Callable[[List[torch.Tensor]], object],
                 zero: bool = True):
        self.specs = dict(specs)
        self.topo = topo
        self.axis = zero_axis(topo)
        n = topo.axis_size(self.axis) if zero else 1
        k = topo.axis_index(self.axis)
        self.group = topo.group(self.axis)
        batch = topo.batch_axes
        batch = (batch,) if isinstance(batch, str) else tuple(batch)
        # the axes an unsharded leaf's gradient is summed over (the batch
        # axes and sp), and a sharded one's after the reduce-scatter (the
        # batch axes besides the zero axis, and sp); a leaf split over
        # one of them (dp: MoE experts) is not summed over it
        self.sum_groups = {}
        self.leaves = []   # (path, param, shard dim or None, state tensor)
        for path, p in params.items():
            spec = specs[path]
            self.sum_groups[path] = (
                topo.group(tuple(a for a in batch + ("sp",)
                                 if a not in spec)),
                topo.group(tuple(a for a in ("dp", "sharding", "sp")
                                 if a != self.axis and a not in spec)))
            shape = [s * (topo.dims[a] if a else 1)
                     for s, a in zip(p.shape, spec)]
            d = zero_shard_dim(spec, shape, self.axis, n) if n > 1 else None
            # the optimizer steps the parameter itself, or this rank's
            # block of it in place (a view: no copy of the weights)
            t = p if d is None else p.detach().narrow(
                d, k * (p.shape[d] // n), p.shape[d] // n)
            self.leaves.append((path, p, d, t))
        self.degree, self.index = n, k
        self.opt = make_optimizer([t for *_, t in self.leaves])

    def step(self, reduced: bool = False) -> None:
        """Reduce the gradients over the batch axes and sp (unless
        ``reduced``: they already hold the sum), step, put the parameters
        back together, and drop the gradients."""
        for path, p, d, t in self.leaves:
            batch_group, rest_group = self.sum_groups[path]
            if d is None:
                if not reduced:
                    C.all_reduce(p.grad, group=batch_group)
                continue
            size = p.shape[d] // self.degree
            if reduced:
                g = p.grad.narrow(d, self.index * size, size).contiguous()
            else:
                g = C.reduce_scatter(p.grad, group=self.group,
                                     dim=d).contiguous()
                C.all_reduce(g, group=rest_group)
            t.grad = g
        self.opt.step()
        with torch.no_grad():
            for _, p, d, t in self.leaves:
                if d is not None:
                    # gathered into a new tensor: the block is a view of p
                    p.copy_(C.all_gather(t, self.group, dim=d))
                    t.grad = None
                p.grad = None

    # -- checkpoint forms -----------------------------------------------
    def zero_specs(self) -> Dict[str, Tuple]:
        """Each path's state placement: the parameter's, plus the zero
        axis on the dimension ZeRO splits (a block a peer does not
        hold)."""
        out = {}
        for path, p, d, _ in self.leaves:
            spec = list(self.specs[path]) + [None] * (p.dim()
                                                     - len(self.specs[path]))
            if d is not None:
                spec[d] = self.axis
            out[path] = tuple(spec)
        return out

    def state_tree(self) -> Dict[str, Dict[str, object]]:
        """This rank's optimizer state by parameter path (ZeRO blocks as
        held; no collective)."""
        return {path: dict(self.opt.state[t]) for path, _, _, t
                in self.leaves if t in self.opt.state}

    def full_state_tree(self) -> Dict[str, Dict[str, object]]:
        """The state by path with every ZeRO block gathered into the
        parameter's shape on this rank (collective over the zero axis:
        every rank calls it)."""
        out = {}
        for path, p, d, t in self.leaves:
            if t not in self.opt.state:
                continue
            st = {}
            for k, v in self.opt.state[t].items():
                if d is not None and torch.is_tensor(v) \
                        and v.dim() == p.dim():
                    v = C.all_gather(v.contiguous(), self.group, dim=d)
                st[k] = v
            out[path] = st
        return out

    def load_state_tree(self, tree: Dict[str, Dict[str, object]]) -> None:
        """Install optimizer state by parameter path: each tensor in the
        parameter's (local) shape, or already this rank's ZeRO block; a
        tensor state moves to the device of the tensor it belongs to,
        the per-step scalars stay where they are.  An empty tree (saved
        before the first step) installs nothing."""
        missing = sorted(path for path, *_ in self.leaves
                         if path not in tree)
        if missing and len(missing) < len(self.leaves):
            raise KeyError(f"optimizer state lacks paths {missing}")
        for path, p, d, t in self.leaves:
            if path not in tree:
                continue
            st = {}
            for k, v in tree[path].items():
                if torch.is_tensor(v) and v.dim() > 0:
                    if d is not None and v.shape == p.shape:
                        size = p.shape[d] // self.degree
                        v = v.narrow(d, self.index * size, size)
                    if v.shape != t.shape:
                        raise ValueError(
                            f"optimizer state {path}/{k}: {tuple(v.shape)} "
                            f"does not fit the parameter block "
                            f"{tuple(t.shape)}")
                    v = v.to(t.device, copy=True,
                             memory_format=torch.contiguous_format)
                elif torch.is_tensor(v):
                    v = v.clone()
                st[k] = v
            self.opt.state[t] = st

    def state_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
        """Each path's optimizer-state tensor shapes (the per-step
        scalars left out)."""
        return {path: tuple(tuple(v.shape)
                            for v in self.opt.state[t].values()
                            if torch.is_tensor(v) and v.dim() > 0)
                for path, _, _, t in self.leaves}

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (the per-step scalars
        left out)."""
        return sum(v.numel() * v.element_size()
                   for *_, t in self.leaves
                   for v in self.opt.state[t].values()
                   if torch.is_tensor(v) and v.dim() > 0)
