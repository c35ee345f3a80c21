"""The hybrid-parallel topology over ``torch.distributed`` ranks (the
port of ``paddle_tpu/distributed/mesh.py``'s ``HybridTopology``).

The reference lays its devices out as one ``jax.sharding.Mesh`` of shape
``(dp, pp, sharding, sp, mp)`` and lets XLA insert the collectives.  Here
each rank is one process: rank ``r`` takes the coordinates of device
``r`` in the reference's ``np.reshape(devices, (dp, pp, sharding, sp,
mp))`` (``mp`` innermost, so the ranks of one tensor-parallel group are
neighbours), and every slice of an axis with more than one rank is a
process group of its own.  An axis slice of one rank is ``ONE_RANK``,
over which the collectives of ``collective.py`` are the identity, so a
world of one process needs no process group at all.

Under context parallelism (``sp`` > 1) the ranks of one ``sp`` slice
hold the same rows of the batch and each its block of the sequence
(``sequence_block``); under pipeline parallelism (``pp`` > 1) the ranks
of one ``pp`` slice hold the same rows and each its block of the layers.

A topology may span only the first ``ranks`` ranks of the world (what
an in-process elastic resize shrinks to, ``Plan.run_train_loop``).
Its groups are made by their members alone
(``new_group(..., use_local_synchronization=True)``), so the ranks past
``ranks``, which may have left, take no part: such a rank may build the
topology (``member`` False, no coordinates, no groups) or not.  A group
of the same ranks is made once per process group and then shared, since
its name comes from its ranks; a second shrink reuses it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["HybridTopology", "init_mesh", "get_topology", "set_topology",
           "ONE_RANK"]

# the axis sets a step reduces over (one group each where every axis of
# the set has more than one rank): the single axes, the batch axes, and
# the batch axes with sp (context-parallel ranks hold partial gradients)
_GROUP_AXES = (("dp",), ("pp",), ("sharding",), ("sp",), ("mp",),
               ("dp", "sharding"), ("dp", "sp"), ("sharding", "sp"),
               ("dp", "sharding", "sp"))

_GLOBAL_TOPO: list = [None]

# (default group, ranks) -> the group of those ranks made by its members
# alone (what a topology over part of the world holds)
_LOCAL_GROUPS: Dict[tuple, dist.ProcessGroup] = {}

AxisName = Union[str, Tuple[str, ...]]


class _OneRank:
    """The group of an axis slice that is this rank alone: every
    collective over it is the identity."""

    def __repr__(self):
        return "ONE_RANK"


ONE_RANK = _OneRank()


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class HybridTopology:
    """Axis names and degrees over the ranks of the default process
    group (or its first ``ranks``), with this rank's coordinates and one
    process group per axis slice.

    ``HybridTopology()`` with every degree 1 is pure data parallelism
    over the whole world (or the first ``ranks``), as the reference's
    default.  The degrees must multiply to the ranks it spans: a rank
    inside it with no coordinates would have nothing to run."""

    AXES = ("dp", "pp", "sharding", "sp", "mp")

    def __init__(self, dp=1, pp=1, sharding=1, mp=1, sp=1, ranks=None):
        rank, world = _world()
        span = world if ranks is None else int(ranks)
        if not 1 <= span <= world:
            raise ValueError(f"a topology over {span} ranks in a world of "
                             f"{world}")
        want = dp * pp * sharding * sp * mp
        if want == 1:
            dp = want = span   # default: pure dp over every rank
        if want != span:
            raise ValueError(
                f"topology {dp}x{pp}x{sharding}x{sp}x{mp}={want} needs "
                f"{want} ranks; the process group has {span}")
        self.dims: Dict[str, int] = {"dp": dp, "pp": pp,
                                     "sharding": sharding, "sp": sp,
                                     "mp": mp}
        self.rank = rank
        self.member = rank < span
        self.mesh = np.arange(span).reshape(
            tuple(self.dims[a] for a in self.AXES))
        self.coords: Dict[str, int] = (
            {a: int(c) for a, c in zip(self.AXES, np.unravel_index(
                rank, self.mesh.shape))} if self.member else {})
        # the groups of axes with more than one rank.  Over the whole
        # world every rank creates every group, in the same order
        # (new_group is collective over the world); over part of it each
        # member creates its own groups only, with its fellow members
        self._local = span < world
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        self._all = None
        if self._local and not self.member:
            return
        for axes in _GROUP_AXES:
            if all(self.dims[a] > 1 for a in axes):
                self._groups[axes] = self._new_group(axes)
        # the group of every rank of the topology, when that is not the
        # whole world
        if 1 < span < world:
            self._all = self._local_group(range(span))

    def _new_group(self, axes: Tuple[str, ...]) -> dist.ProcessGroup:
        idx = [self.AXES.index(a) for a in axes]
        n = self.axis_size(axes)
        rows = np.moveaxis(self.mesh, idx, range(-len(idx), 0)).reshape(-1, n)
        if self._local:
            return self._local_group(next(r for r in rows
                                          if self.rank in r))
        mine = None
        for row in rows:
            g = dist.new_group([int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    @staticmethod
    def _local_group(ranks) -> dist.ProcessGroup:
        key = (dist.group.WORLD, tuple(int(r) for r in ranks))
        if key not in _LOCAL_GROUPS:
            _LOCAL_GROUPS[key] = dist.new_group(
                list(key[1]), use_local_synchronization=True)
        return _LOCAL_GROUPS[key]

    def all_ranks(self):
        """The group of every rank of the topology: ``ONE_RANK`` for a
        topology of one, the default group when it spans the world."""
        if self.world_size() == 1:
            return ONE_RANK
        return self._all if self._all is not None else dist.group.WORLD

    # -- axes -----------------------------------------------------------
    @staticmethod
    def _axes(axis: AxisName) -> Tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def group(self, axis: AxisName):
        """The process group of this rank's slice of ``axis`` (a name or
        a tuple of names), or ``ONE_RANK`` when the slice is this rank
        alone."""
        axes = tuple(a for a in self._axes(axis) if self.dims[a] > 1)
        if not axes:
            return ONE_RANK
        return self._groups[axes]

    def axis_size(self, axis: AxisName) -> int:
        return int(np.prod([self.dims[a] for a in self._axes(axis)]))

    def axis_index(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (row-major over a tuple):
        also its rank in ``group(axis)``."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.dims[a] + self.coords[a]
        return idx

    # -- the reference's surface ------------------------------------------
    def world_size(self):
        return int(np.prod(list(self.dims.values())))

    @property
    def dp_degree(self):
        return self.dims["dp"]

    @property
    def pp_degree(self):
        return self.dims["pp"]

    @property
    def sharding_degree(self):
        return self.dims["sharding"]

    @property
    def sp_degree(self):
        return self.dims["sp"]

    @property
    def mp_degree(self):
        return self.dims["mp"]

    @property
    def batch_axes(self) -> AxisName:
        """The axes the global batch splits over: with a carved-out
        ``sharding`` (ZeRO) axis the data-parallel world is dp x
        sharding."""
        return ("dp", "sharding") if self.dims["sharding"] > 1 else "dp"

    def shard_batch(self, batch: Dict[str, object],
                    microbatches: int = 1) -> Dict[str, object]:
        """This rank's rows of a global batch (the reference's
        ``P(batch_axes, None)`` placement): the batch ranks take equal
        contiguous blocks of rows in the order of their index.  With
        ``microbatches`` = m > 1 (a pipeline's), the rows split into m
        global microbatches first and each batch rank takes its block
        of every one, in order: its microbatch ``i`` is then its share
        of the global microbatch ``i``, which the reference's pipeline
        splits off the global batch (a MoE layer routes its tokens
        together)."""
        n, i = self.axis_size(self.batch_axes), self.axis_index(
            self.batch_axes)
        out = {}
        for k, v in batch.items():
            rows = v.shape[0]
            if rows % (n * microbatches):
                raise ValueError(f"batch of {rows} rows does not split "
                                 f"over {n} batch ranks x {microbatches} "
                                 f"microbatches")
            b = rows // (n * microbatches)
            blocks = [v[(m * n + i) * b:(m * n + i + 1) * b]
                      for m in range(microbatches)]
            out[k] = blocks[0] if microbatches == 1 else (
                torch.cat(blocks) if torch.is_tensor(v)
                else np.concatenate(blocks))
        return out

    def sequence_block(self, seq_len: int) -> range:
        """This rank's block of a sequence of ``seq_len`` positions under
        context parallelism (the reference's ``P(None, "sp")`` placement
        of the sequence dim): equal contiguous blocks in the order of
        the ``sp`` index.  The range is both the slice of the sequence
        dim and the block's absolute positions (its rope rows)."""
        n, i = self.dims["sp"], self.coords["sp"]
        if seq_len % n:
            raise ValueError(f"sequence {seq_len} does not split over "
                             f"sp={n}")
        b = seq_len // n
        return range(i * b, (i + 1) * b)

    def __repr__(self):
        dims = ", ".join(f"{a}={d}" for a, d in self.dims.items())
        return f"HybridTopology({dims}, rank={self.rank})"


def init_mesh(dp=1, pp=1, sharding=1, mp=1, sp=1, ranks=None
              ) -> HybridTopology:
    """Build the topology over the current process group (or its first
    ``ranks``) and make it the process's own (``get_topology``)."""
    topo = HybridTopology(dp, pp, sharding, mp, sp=sp, ranks=ranks)
    _GLOBAL_TOPO[0] = topo
    return topo


def set_topology(topo: Optional[HybridTopology]) -> None:
    _GLOBAL_TOPO[0] = topo


def get_topology(create: bool = True) -> Optional[HybridTopology]:
    """The topology ``init_mesh`` built; with none yet, the default (pure
    dp over the world), unless ``create`` is False."""
    if _GLOBAL_TOPO[0] is None and create:
        init_mesh()
    return _GLOBAL_TOPO[0]
