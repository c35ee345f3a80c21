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
host wall time, each by ``op``) when ``FLAGS_tpu_metrics`` is on, and a
``collective/<op>`` span when ``FLAGS_tpu_trace`` is on.  Every call,
over one rank too, runs inside ``runtime.health.collective_beacon(op)``
and passes the ``collective.<op>`` chaos point (stamped with the health
monitor's step), as the reference's ``_apply_collective`` does: with no
monitor and no schedule installed that is two ``None`` checks.  The
eager ``Tensor`` facade stays out (ROADMAP A4).
"""
from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..profiler import metrics as _metrics
from ..profiler import trace as _trace
from ..runtime import health as _health
from ..testing.chaos import chaos_point

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "all_to_all", "ppermute", "ppermute_grad",
           "barrier", "resolve_group", "group_rank"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    AVG = "avg"


# AVG is SUM then a division: gloo has no AVG
_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
              "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

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
    """Metrics and the trace span of one collective call."""

    __slots__ = ("op", "nbytes", "t0", "span")

    def __init__(self, op: str, tensor: torch.Tensor, nbytes=None):
        self.op = op
        self.nbytes = (tensor.numel() * tensor.element_size()
                       if nbytes is None else nbytes)
        self.t0 = time.perf_counter() if _metrics.enabled() else None
        self.span = _trace.span(f"collective/{op}", op=op)

    def __enter__(self):
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
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
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
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
def all_gather(tensor: torch.Tensor, group=None, dim: int = 0
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
def reduce_scatter(tensor: torch.Tensor, op: str = ReduceOp.SUM,
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
def broadcast(tensor: torch.Tensor, src: int = 0, group=None
              ) -> torch.Tensor:
    """Overwrite ``tensor`` in place with group rank ``src``'s."""
    pg = resolve_group(group)
    if pg is None:
        return tensor
    with _Recorded("broadcast", tensor):
        dist.broadcast(tensor, dist.get_global_rank(pg, src), group=pg)
    return tensor


@_instrumented("alltoall")
def all_to_all(tensor: torch.Tensor, group=None) -> torch.Tensor:
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
