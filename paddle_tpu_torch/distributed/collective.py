"""Collectives on plain tensors over the topology's axis groups (the
functional half of ``paddle_tpu/distributed/collective.py``).

The reference's collectives are XLA ops over named mesh axes.  Here a
``group`` is an axis name or a tuple of them (resolved through the
topology ``mesh.init_mesh`` built), what ``HybridTopology.group``
returns (a ``torch.distributed`` ``ProcessGroup``, or ``ONE_RANK``), or
None for the whole world.  Over a group of one rank every operation is
the identity and moves nothing, so a world of one process runs the same
code with no process group.

``ppermute`` is the reference's ``lax.ppermute`` over one axis: every
rank sends to the rank ``shift`` places on and receives from the rank
``shift`` places back, with every send and receive posted before any is
waited on (a ring of blocking sends could deadlock).  A pipeline names,
per call, whether this rank sends and whether it receives (a stage with
no work on a tick moves nothing); both ends of an edge derive that from
the same schedule.  ``ppermute_grad`` is its autograd form: the
backward applies the reverse shift to the gradient, the reference's
transpose of ``ppermute``.

Every call over more than one rank records the reference's metrics at
the same point (``collective_calls_total``, ``collective_bytes_total``
of the input bytes and the ``collective_latency_seconds`` histogram of
host wall time, each by ``op``) when ``FLAGS_tpu_metrics`` is on, a
``collective/<op>`` host span while a ``Profiler`` is live, and a
``collective/<op>`` trace span when ``FLAGS_tpu_trace`` is on.  Every call,
over one rank too, runs inside ``runtime.health.collective_beacon(op)``
and passes the ``collective.<op>`` chaos point (stamped with the health
monitor's step), as the reference's ``_apply_collective`` does: with no
monitor and no schedule installed that is two ``None`` checks.

The first half of this file (``_all_reduce``, ``_all_gather``,
``_reduce_scatter``, ``_broadcast``, ``_all_to_all``, ``ppermute``)
takes ``torch.Tensor`` and group ranks; the train step, the pipeline,
MoE and ZeRO call it.  The public names of the second half are the
reference's eager facade over the port's ``Tensor`` (``Group``,
``new_group``, ``all_reduce`` in place, ``all_gather`` into a list,
``scatter``, ``send`` / ``recv`` and the rest), with Paddle's
arguments alone: ranks (``src``, ``dst``) are global ranks, as in
Paddle.  Every facade call runs one of the instrumented functions, so
it records the same metrics, spans, beacon and chaos point.  Over a
group of one rank every facade op is the identity, as the reference's
eager facade is; over more ranks it communicates (the reference's
eager facade raises there and leaves multi-rank work to compiled
programs).
"""
from __future__ import annotations

import datetime
import functools
import os
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.tensor import Tensor
from ..profiler import _record_span
from ..profiler import metrics as _metrics
from ..profiler import trace as _trace
from ..runtime import health as _health
from ..testing.chaos import chaos_point

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "all_to_all", "ppermute", "ppermute_grad",
           "barrier", "resolve_group", "group_rank", "Group", "new_group",
           "get_group", "get_rank", "get_world_size", "is_initialized",
           "destroy_process_group", "get_backend", "wait", "stream",
           "all_gather_object", "reduce", "scatter", "alltoall",
           "alltoall_single", "send", "recv", "isend", "irecv",
           "broadcast_object_list", "scatter_object_list", "gloo_barrier",
           "gloo_release"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# AVG is SUM then a division: gloo has no AVG
_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
              "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
              "prod": dist.ReduceOp.PRODUCT}

# torch 2.13 renamed the tensor forms (``*_single``); the old names take
# the same arguments
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)
_all_gather_tensor = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


class _Done:
    """The handle an asynchronous call over a group of one returns."""

    def wait(self):
        return True


def resolve_group(group) -> Optional[dist.ProcessGroup]:
    """The process group ``group`` names, or None when it is one rank."""
    from .mesh import ONE_RANK, get_topology
    if isinstance(group, Group):
        group = group._resolve()
    if isinstance(group, (str, tuple)):
        group = get_topology().group(group)
    if group is ONE_RANK:
        return None
    if group is None:
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return None
        group = dist.group.WORLD
    return group if dist.get_world_size(group) > 1 else None


def group_rank(group) -> Tuple[int, int]:
    """(size, this rank's index) of ``group``; (1, 0) for one rank."""
    pg = resolve_group(group)
    if pg is None:
        return 1, 0
    return dist.get_world_size(pg), dist.get_rank(pg)


class _Recorded:
    """Metrics, the Profiler's host span and the trace span of one
    collective call."""

    __slots__ = ("op", "nbytes", "t0", "span", "host")

    def __init__(self, op: str, tensor: torch.Tensor, nbytes=None):
        self.op = op
        self.nbytes = (tensor.numel() * tensor.element_size()
                       if nbytes is None else nbytes)
        self.t0 = time.perf_counter() if _metrics.enabled() else None
        self.host = _record_span(f"collective/{op}")
        self.span = _trace.span(f"collective/{op}", op=op)

    def __enter__(self):
        self.host.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        self.host.__exit__(*exc)
        if self.t0 is not None and exc[0] is None:
            op = self.op
            _metrics.counter("collective_calls_total",
                             "Collective invocations", op=op).inc()
            _metrics.counter("collective_bytes_total",
                             "Input bytes handed to collectives",
                             op=op).inc(self.nbytes)
            _metrics.histogram(
                "collective_latency_seconds",
                "Host wall time per collective call (launch time for an "
                "asynchronous one)", op=op).observe(
                    time.perf_counter() - self.t0)
        return False


def _instrumented(op_name: str):
    """Run the op inside the health beacon, past the ``collective.<op>``
    chaos point: the beacon is outermost, so an injected hang counts as
    inside the collective and the rank's own monitor sees it overdue."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _health.collective_beacon(op_name):
                chaos_point(f"collective.{op_name}",
                            step=_health.current_step())
                return fn(*args, **kwargs)
        return call
    return wrap


@_instrumented("all_reduce")
def _all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               async_op: bool = False):
    """Reduce ``tensor`` in place over the group.  Returns the tensor, or
    with ``async_op`` a handle whose ``wait()`` orders later work after
    the reduction (``avg`` is not asynchronous)."""
    pg = resolve_group(group)
    if pg is None:
        return _Done() if async_op else tensor
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    if async_op and op == ReduceOp.AVG:
        raise ValueError("an asynchronous all_reduce takes no 'avg'")
    with _Recorded("all_reduce", tensor):
        work = dist.all_reduce(tensor, op=_TORCH_OPS[op], group=pg,
                               async_op=async_op)
    if async_op:
        return work
    if op == ReduceOp.AVG:
        tensor.div_(dist.get_world_size(pg))
    return tensor


@_instrumented("all_gather")
def _all_gather(tensor: torch.Tensor, group=None, dim: int = 0
               ) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank
    order (the reference's tiled gather)."""
    pg = resolve_group(group)
    if pg is None:
        return tensor
    n = dist.get_world_size(pg)
    x = tensor.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _Recorded("all_gather", tensor):
        _all_gather_tensor(out, x, group=pg)
    return out.movedim(0, dim)


@_instrumented("reduce_scatter")
def _reduce_scatter(tensor: torch.Tensor, op: str = ReduceOp.SUM,
                   group=None, dim: int = 0) -> torch.Tensor:
    """Reduce over the group, then keep this rank's block of ``dim``
    (the reference's tiled ``psum_scatter``); ``dim`` must divide by the
    group size."""
    pg = resolve_group(group)
    if pg is None:
        return tensor
    n = dist.get_world_size(pg)
    if tensor.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                         f"split over {n} ranks")
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter takes 'sum' or 'avg', not {op!r}")
    x = tensor.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _Recorded("reduce_scatter", tensor):
        _reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=pg)
    if op == ReduceOp.AVG:
        out.div_(n)
    return out.movedim(0, dim)


@_instrumented("broadcast")
def _broadcast(tensor: torch.Tensor, src: int = 0, group=None
              ) -> torch.Tensor:
    """Overwrite ``tensor`` in place with group rank ``src``'s."""
    pg = resolve_group(group)
    if pg is None:
        return tensor
    with _Recorded("broadcast", tensor):
        dist.broadcast(tensor, dist.get_global_rank(pg, src), group=pg)
    return tensor


@_instrumented("alltoall")
def _all_to_all(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Split dim 0 into one block per rank, send block ``i`` to group
    rank ``i`` and stack what arrives in rank order (the reference's
    ``lax.all_to_all`` with split and concat axis 0)."""
    pg = resolve_group(group)
    if pg is None:
        return tensor
    n = dist.get_world_size(pg)
    if tensor.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(tensor.shape)} does not split "
                         f"over {n} ranks")
    x = tensor.contiguous()
    out = torch.empty_like(x)
    with _Recorded("alltoall", tensor):
        dist.all_to_all_single(out, x, group=pg)
    return out


class _P2P:
    """The posted sends and receives of one ``ppermute``: ``wait()``
    returns what arrived (None when this rank receives nothing)."""

    def __init__(self, works, out, staged, keep=None):
        self.works, self.out, self.staged = works, out, staged
        self.keep = keep        # a staged send's host buffer, until sent

    def wait(self) -> Optional[torch.Tensor]:
        for w in self.works:
            w.wait()
        self.works = self.keep = []
        if self.staged is not None:
            self.out.copy_(self.staged)
            self.staged = None
        return self.out


@_instrumented("ppermute")
def ppermute(tensor: torch.Tensor, group, shift: int = 1, *,
             send: bool = True, recv: bool = True, async_op: bool = False):
    """Send ``tensor`` to the group rank ``shift`` places on and receive
    a tensor of its shape and type from the rank ``shift`` places back
    (the reference's ``lax.ppermute`` with the pairs ``(i, i + shift)``).
    ``send``/``recv`` False: this rank sends or receives nothing on this
    call (``tensor`` is then only the template of what arrives); the
    peers must agree.  Returns what arrived (None when ``recv`` is
    False), or with ``async_op`` a handle whose ``wait()`` returns it.
    Over one rank it is the identity; a call that neither sends nor
    receives moves and records nothing.  Sends and receives of a negative
    shift travel under their own tag, so the two directions of a pair
    never match each other's messages."""
    pg = resolve_group(group)
    if pg is None or not (send or recv):
        out = tensor if (pg is None and send and recv) else None
        return _P2P([], out, None) if async_op else out
    n, i = dist.get_world_size(pg), dist.get_rank(pg)
    dst = dist.get_global_rank(pg, (i + shift) % n)
    src = dist.get_global_rank(pg, (i - shift) % n)
    tag = 0 if shift >= 0 else 1
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format) \
        if recv else None
    works = []
    staged = x = None
    stage = tensor.is_cuda and dist.get_backend(pg) in _HOST_P2P
    with _Recorded("ppermute", tensor,
                   tensor.numel() * tensor.element_size() if send else 0):
        if recv:
            staged = _host(out) if stage else None
            works.append(dist.irecv(out if staged is None else staged,
                                    src=src, group=pg, tag=tag))
        if send:
            x = tensor.contiguous()
            if stage:
                x = _host(x, copy=True)
            works.append(dist.isend(x, dst=dst, group=pg, tag=tag))
    handle = _P2P(works, out, staged, [x])
    return handle if async_op else handle.wait()


# backends whose point-to-point calls read a CUDA tensor's pointer as
# host memory (gloo: "writev ... Bad address" on the H100 machine's
# torch 2.11.0+cu128), so a device tensor crosses through a pinned host
# copy; their collectives take CUDA tensors
_HOST_P2P = ("gloo",)


def _host(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape (and bytes, with ``copy``)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
    return h


class _PPermuteGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, group, shift, send, recv):
        ctx.args = (group, shift, send, recv)
        ctx.meta = (x.shape, x.dtype, x.device)
        out = ppermute(x, group, shift, send=send, recv=recv)
        if out is None:
            # nothing arrives: an empty tensor the caller ties into its
            # loss, so that the backward still receives the gradient
            return x.new_empty((0,))
        return out

    @staticmethod
    def backward(ctx, g):
        group, shift, send, recv = ctx.args
        shape, dtype, device = ctx.meta
        # the reverse shift: the gradient of what arrived goes back to its
        # sender, the gradient of what was sent comes back from its peer
        tmpl = g.contiguous() if recv else torch.empty(
            shape, dtype=dtype, device=device)
        gx = ppermute(tmpl, group, -shift, send=recv, recv=send)
        return gx, None, None, None, None, None


def ppermute_grad(x: torch.Tensor, group, shift: int = 1, *,
                  send: bool = True, recv: bool = True,
                  anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ppermute`` as an autograd function: the backward sends the
    gradient of what arrived back to its sender and receives the
    gradient of ``x`` from the rank it went to.  With ``recv`` False it
    returns an empty tensor; the caller ties it into its loss so the
    backward runs.  ``anchor``, a tensor that requires grad, puts a call
    that only receives (``x`` then a template) into the graph."""
    if anchor is None:
        anchor = x.new_empty((0,))
    return _PPermuteGrad.apply(x, anchor, group, shift, send, recv)


def barrier(group=None) -> None:
    pg = resolve_group(group)
    if pg is not None:
        dist.barrier(group=pg)


# ---------------------------------------------------------------------------
# the eager Tensor facade (the reference's collective.py:42-440)
# ---------------------------------------------------------------------------

def _world() -> Tuple[int, int]:
    """(this rank, world size): the process group's, else the launcher's
    environment, else a world of one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    return (int(env.get("PADDLE_TRAINER_ID", env.get("RANK", "0"))),
            int(env.get("PADDLE_TRAINERS_NUM", env.get("WORLD_SIZE", "1"))))


class Group:
    """A group of global ranks (the reference's ``Group``, whose mesh
    axis is here a ``torch.distributed`` process group).  Group 0 is the
    whole world, whatever its size when it is used."""

    def __init__(self, ranks=None, pg=None, gid=0, name=None):
        self._ranks = None if ranks is None else [int(r) for r in ranks]
        self.process_group = pg
        self.id = gid
        self.name = name or f"_default_pg{gid}"

    @property
    def ranks(self) -> List[int]:
        if self._ranks is None:
            return list(range(_world()[1]))
        return list(self._ranks)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This rank's index in the group; -1 outside it."""
        return self.get_group_rank(_world()[0])

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        ranks = self.ranks
        return ranks.index(rank) if rank in ranks else -1

    def _resolve(self):
        from .mesh import ONE_RANK
        if self.id == 0:
            return None
        return ONE_RANK if self.process_group is None else self.process_group

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_GROUPS = {0: Group(gid=0)}
_NEXT_GID = [1]


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group of the global ``ranks`` (default: all).  Over a world of
    several ranks every rank calls it, members or not, as
    ``torch.distributed.new_group`` requires."""
    _, world = _world()
    ranks = sorted(range(world) if ranks is None else (int(r)
                                                       for r in ranks))
    pg = None
    if dist.is_initialized() and world > 1:
        pg = dist.new_group(ranks, backend=backend, timeout=None if timeout
                            is None else datetime.timedelta(seconds=timeout))
    gid = _NEXT_GID[0]
    _NEXT_GID[0] += 1
    _GROUPS[gid] = Group(ranks, pg, gid)
    return _GROUPS[gid]


def get_group(gid: int = 0) -> Optional[Group]:
    return _GROUPS.get(gid)


def get_rank(group=None) -> int:
    """The global rank, or with ``group`` this rank's index in it (-1
    outside)."""
    if isinstance(group, Group):
        return group.rank
    return _world()[0]


def get_world_size(group=None) -> int:
    if isinstance(group, Group):
        return group.nranks
    return _world()[1]


def is_initialized() -> bool:
    """Whether a process group was joined (``init_parallel_env``)."""
    return dist.is_available() and dist.is_initialized()


def destroy_process_group(group=None) -> None:
    """Without ``group``, leave the process group (``shutdown``);
    otherwise free that group."""
    if group is None:
        from .store import shutdown
        shutdown()
        for gid in [g for g in _GROUPS if g]:
            del _GROUPS[gid]
        return
    pg = group.process_group if isinstance(group, Group) else group
    if pg is not None and dist.is_initialized():
        dist.destroy_process_group(pg)
    if isinstance(group, Group):
        _GROUPS.pop(group.id, None)


def get_backend(group=None) -> Optional[str]:
    """The group's backend, upper case ("NCCL", "GLOO"); None outside a
    process group."""
    if not is_initialized():
        return None
    pg = group._resolve() if isinstance(group, Group) else group
    if pg is None or not isinstance(pg, dist.ProcessGroup):
        pg = dist.group.WORLD
    return str(dist.get_backend(pg)).upper()


def wait(tensor, group=None, use_calc_stream=True) -> None:
    """Block the host until the work queued on ``tensor``'s device is
    done."""
    t = tensor._t if isinstance(tensor, Tensor) else tensor
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class _Task:
    """What a facade call with ``sync_op=False`` returns."""

    def __init__(self, work=None):
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return True

    def is_completed(self):
        return self._work is None


def _index(group, rank: int) -> int:
    """The global ``rank``'s index in ``group``'s process group."""
    pg = resolve_group(group)
    return 0 if pg is None else dist.get_group_rank(pg, rank)


def _in_place(tensor: Tensor, fn) -> None:
    """``fn(t)`` on a contiguous buffer of the facade's tensor, the
    result written back into it (no autograd record)."""
    t = tensor._t
    with torch.no_grad():
        buf = t if t.is_contiguous() else t.contiguous()
        fn(buf)
        if buf is not t:
            t.copy_(buf)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over ``group`` in place (``op``: SUM, MAX, MIN,
    PROD or AVG)."""
    if not sync_op and op != ReduceOp.AVG:
        with torch.no_grad():
            return _Task(_all_reduce(tensor._t, op, group, async_op=True))
    _in_place(tensor, lambda b: _all_reduce(b, op, group))
    return tensor if sync_op else _Task()


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Paddle's ``all_gather(tensor_list, tensor)``: every rank's
    ``tensor`` into ``tensor_list``, in group order.  Given a ``Tensor``
    alone: the group's tensors stacked on a new leading axis (the
    reference's traced form; over one rank the tensor itself)."""
    if tensor is None:
        x = tensor_list
        if group_rank(group)[0] == 1:
            return x
        return Tensor._wrap(_all_gather(x._t.detach()[None].contiguous(),
                                        group, 0))
    out = _all_gather(tensor._t.detach()[None].contiguous(), group, 0)
    tensor_list.clear()
    tensor_list.extend(Tensor._wrap(o) for o in out.unbind(0))
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable ``obj`` into ``object_list``."""
    n, _ = group_rank(group)
    object_list.clear()
    if n == 1:
        object_list.append(obj)
        return object_list
    got = [None] * n
    dist.all_gather_object(got, obj, group=resolve_group(group))
    object_list.extend(got)
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Overwrite ``tensor`` in place with the global rank ``src``'s."""
    _in_place(tensor, lambda b: _broadcast(b, _index(group, src), group))
    return tensor if sync_op else _Task()


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on every rank, ``dst`` among them (the
    reference's: an all-reduce whose result ``dst`` uses)."""
    return all_reduce(tensor, op, group, sync_op)


@_instrumented("scatter")
def _scatter(out: torch.Tensor, parts, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``parts[i]`` into group rank ``i``'s
    ``out``."""
    pg = resolve_group(group)
    me = dist.get_rank(pg)
    stage = out.is_cuda and dist.get_backend(pg) in _HOST_P2P
    buf = _host(out) if stage else out
    send = None
    if me == src:
        send = [(_host(p, copy=True) if stage else p.contiguous())
                for p in parts]
    with _Recorded("scatter", out):
        dist.scatter(buf, send, src=dist.get_global_rank(pg, src),
                     group=pg)
    if stage:
        out.copy_(buf)
    return out


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank ``i``'s ``tensor`` receives the global rank ``src``'s
    ``tensor_list[i]`` (only ``src`` passes the list, as in Paddle).  A
    ``src`` without a list sends the blocks of its own ``tensor`` split
    along dim 0 and keeps its block (the reference's traced form, which
    equals it on a replicated input); the others' ``tensor`` is then a
    block's shape."""
    n, i = group_rank(group)
    s = _index(group, src)
    with torch.no_grad():
        if n == 1:
            if tensor_list:
                _in_place(tensor, lambda b: b.copy_(tensor_list[0]._t))
            return tensor if sync_op else _Task()
        if i != s:
            _in_place(tensor, lambda b: _scatter(b, None, s, group))
        elif tensor_list is not None:
            if len(tensor_list) != n:
                raise ValueError(f"scatter: {len(tensor_list)} tensors for "
                                 f"{n} ranks")
            _in_place(tensor, lambda b: _scatter(
                b, [t._t for t in tensor_list], s, group))
        else:
            blocks = tensor._t.chunk(n, 0)
            out = torch.empty_like(blocks[s],
                                   memory_format=torch.contiguous_format)
            tensor._set_array(_scatter(out, blocks, s, group))
    return tensor if sync_op else _Task()


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Group rank ``j`` receives every rank's ``in_tensor_list[j]``, in
    rank order, into ``out_tensor_list``.  A single ``Tensor``: dim 0
    split into one block a rank, block ``j`` to rank ``j`` (the
    reference's traced form)."""
    with torch.no_grad():
        if isinstance(in_tensor_list, Tensor):
            return Tensor._wrap(_all_to_all(in_tensor_list._t, group))
        stacked = torch.stack([t._t for t in in_tensor_list])
        parts = [Tensor._wrap(p) for p in
                 _all_to_all(stacked, group).unbind(0)]
    if out_tensor_list is None:
        return parts
    out_tensor_list.clear()
    out_tensor_list.extend(parts)
    return out_tensor_list


all_to_all = alltoall


@_instrumented("alltoall_single")
def _alltoall_single(x: torch.Tensor, in_splits, out_splits, group
                     ) -> torch.Tensor:
    pg = resolve_group(group)
    if pg is None:
        return x
    rows = sum(out_splits) if out_splits is not None else x.shape[0]
    out = torch.empty((rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    with _Recorded("alltoall_single", x):
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits,
                               group=pg)
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Rows of ``in_tensor`` to the ranks by ``in_split_sizes`` (equal
    blocks without), received by ``out_split_sizes`` (what the peers
    send, exchanged first when only ``in_split_sizes`` is given)."""
    x = in_tensor._t
    n, _ = group_rank(group)
    with torch.no_grad():
        ins = None if in_split_sizes is None else [int(v) for v in
                                                   in_split_sizes]
        outs = None if out_split_sizes is None else [int(v) for v in
                                                     out_split_sizes]
        if ins is not None and outs is None and n > 1:
            sizes = torch.tensor(ins, dtype=torch.int64, device=x.device)
            outs = [int(v) for v in _all_to_all(sizes, group).tolist()]
        out = _alltoall_single(x, ins, outs, group)
        if out_tensor is None:
            return Tensor._wrap(out)
        out_tensor._set_array(out)
    return out_tensor if sync_op else _Task()


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Group rank ``i``'s ``tensor`` becomes the reduction of every
    rank's ``tensor_list[i]``.  A ``Tensor`` alone: the reduction's
    block of dim 0 (the reference's traced form), returned."""
    with torch.no_grad():
        if tensor_list is None:
            return Tensor._wrap(_reduce_scatter(tensor._t, op, group, 0))
        n, _ = group_rank(group)
        if len(tensor_list) != n:
            raise ValueError(f"reduce_scatter: {len(tensor_list)} tensors "
                             f"for {n} ranks")
        flat = torch.cat([t._t.reshape((1, *t._t.shape))
                          for t in tensor_list])
        out = _reduce_scatter(flat, op, group, 0)[0]
        _in_place(tensor, lambda b: b.copy_(out))
    return tensor if sync_op else _Task()


@_instrumented("send")
def _send(t: torch.Tensor, dst: int, group, async_op: bool):
    pg = resolve_group(group)
    if pg is None:
        return _P2P([], t, None)
    stage = t.is_cuda and dist.get_backend(pg) in _HOST_P2P
    x = _host(t, copy=True) if stage else t.contiguous()
    with _Recorded("send", t):
        work = dist.isend(x, dst=dst, group=pg)
    return _P2P([work], None, None, [x])


@_instrumented("recv")
def _recv(t: torch.Tensor, src: int, group, async_op: bool):
    pg = resolve_group(group)
    if pg is None:
        return _P2P([], t, None)
    stage = t.is_cuda and dist.get_backend(pg) in _HOST_P2P
    staged = _host(t) if stage else None
    with _Recorded("recv", t):
        work = dist.irecv(t if staged is None else staged, src=src,
                          group=pg)
    return _P2P([work], t, staged)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to the global rank ``dst``."""
    task = _send(tensor._t.detach(), dst, group, not sync_op)
    if sync_op:
        task.wait()
        return tensor
    return _Task(task)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` (in place) from the global rank ``src``."""
    with torch.no_grad():
        task = _recv(tensor._t, src, group, not sync_op)
        if sync_op:
            task.wait()
            return tensor
    return _Task(task)


def isend(tensor, dst=0, group=None):
    """``send`` that returns a task; its ``wait()`` completes it."""
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    """``recv`` that returns a task; ``tensor`` holds what arrived once
    its ``wait()`` returns."""
    return recv(tensor, src, group, sync_op=False)


def broadcast_object_list(object_list, src=0, group=None):
    """The global rank ``src``'s picklable objects into every rank's
    ``object_list`` (in place)."""
    if group_rank(group)[0] > 1:
        dist.broadcast_object_list(object_list, src=src,
                                   group=resolve_group(group))
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Group rank ``i`` receives the global rank ``src``'s
    ``in_object_list[i]`` as ``out_object_list[0]``."""
    n, i = group_rank(group)
    if n == 1:
        if in_object_list:
            out_object_list.clear()
            out_object_list.append(in_object_list[0])
        return out_object_list
    got = [None]
    pg = resolve_group(group)
    dist.scatter_object_list(got, in_object_list if get_rank() == src
                             else None, src=src, group=pg)
    out_object_list.clear()
    out_object_list.extend(got)
    return out_object_list


def gloo_barrier() -> None:
    """A barrier over the world (the reference's gloo context barrier)."""
    barrier()


def gloo_release() -> None:
    """Nothing to free: the gloo context is the process group's."""


class stream:
    """``paddle.distributed.communication.stream``: the same
    collectives (one stream orders them here too)."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    reduce_scatter = staticmethod(reduce_scatter)
    send = staticmethod(send)
    recv = staticmethod(recv)
