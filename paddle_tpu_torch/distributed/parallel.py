"""The parallel environment and ``DataParallel`` (the port of
``paddle_tpu/distributed/parallel.py``).

``init_parallel_env`` reads the launcher's environment (``PADDLE_*`` or
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``) and joins
the process group over ``store.init_parallel_env``: NCCL when each rank
has a card of its own, gloo when ranks share one (NCCL refuses two ranks
on one device) or run on the CPU.  A world of one joins nothing, as the
reference starts no coordinator for one process.  Either way the
topology is built once (``mesh.init_mesh``).

``DataParallel`` wraps a ``Layer``.  The reference needs no reduction of
its own (GSPMD inserts the ``pmean`` in the compiled step); here every
rank runs its own backward, so the wrapper averages the gradients over
the group while the backward runs: a post-accumulate hook on each
parameter marks it ready, a bucket whose parameters are all ready is
flattened and its asynchronous all-reduce started (``overlap.Reducer``),
and at the end of the backward the reductions are waited on, divided by
the group size and written back into the gradients (each marked as
averaged).  The buckets are
``overlap.plan_buckets`` over the parameters in reverse order (the
order their gradients arrive), the first of ``last_comm_buffer_size``
MB and the rest of ``comm_buffer_size`` MB, as Paddle's reducer groups
them.  ``apply_collective_grads`` (and ``fleet.utils.
fused_allreduce_gradients``, over ``average_gradients``) averages only
the gradients no hook or earlier call has averaged since their last
backward, so calling it after a backward (the reference's idiom) does
not divide a second time.
"""
from __future__ import annotations

import contextlib
import os
import weakref
from typing import List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..nn.layer.layers import Layer
from . import collective as C
from . import store as _store
from .mesh import get_topology, init_mesh
from .overlap import Reducer, bucketed_psum, plan_buckets

__all__ = ["init_parallel_env", "shutdown", "ParallelEnv", "DataParallel",
           "sync_params_buffers", "average_gradients"]


def _env(*names, default=None):
    for n in names:
        if n in os.environ:
            return os.environ[n]
    return default


def init_parallel_env(strategy=None, *, device=None,
                      backend: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      master: Optional[str] = None,
                      timeout: float = 300.0) -> "ParallelEnv":
    """Join the process group the launcher's environment describes (once)
    and build the topology; returns ``ParallelEnv()``.

    ``device``: the card unless the caller names another (a device given
    as the first argument is taken as ``device``).  ``rank`` and
    ``world_size`` override the environment; given explicitly they form
    a process group even for a world of one.  ``master``: the store's
    ``host:port`` (default ``PADDLE_MASTER``, else ``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    if isinstance(strategy, (str, torch.device)):
        device, strategy = strategy, None
    if not dist.is_initialized():
        explicit = world_size is not None
        if rank is None:
            rank = int(_env("PADDLE_TRAINER_ID", "RANK", default="0"))
        if world_size is None:
            world_size = int(_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                  default="1"))
        if world_size > 1 or explicit:
            dev = resolve_device(device)
            store = None
            master = master or _env("PADDLE_MASTER", "MASTER_ADDR")
            if master and ":" in master:
                host, port = master.rsplit(":", 1)
                store = _store.TCPStore(
                    host, int(port), rank == 0, world_size, timeout)
            if backend is None and dev.type == "cuda":
                local = int(_env("LOCAL_WORLD_SIZE", "PADDLE_LOCAL_SIZE",
                                 default=str(world_size)))
                backend = ("nccl" if local <= torch.cuda.device_count()
                           else "gloo")
            _store.init_parallel_env(dev, backend=backend, store=store,
                                     rank=rank, world_size=world_size,
                                     timeout=timeout)
    if get_topology(create=False) is None:
        init_mesh()
    return ParallelEnv()


def shutdown():
    """Leave the process group (the inverse of ``init_parallel_env``);
    a no-op when there is none."""
    C.destroy_process_group()


class ParallelEnv:
    """The reference's ``ParallelEnv``: this process's place in the
    world."""

    @property
    def rank(self) -> int:
        return C.get_rank()

    @property
    def world_size(self) -> int:
        return C.get_world_size()

    nranks = world_size

    @property
    def local_rank(self) -> int:
        return int(_env("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                        default=str(self.rank)))

    @property
    def device_id(self) -> int:
        if torch.cuda.is_available():
            return self.local_rank % torch.cuda.device_count()
        return self.local_rank

    dev_id = device_id

    @property
    def trainer_endpoints(self) -> List[str]:
        return _env("PADDLE_TRAINER_ENDPOINTS", default="").split(",")

    @property
    def current_endpoint(self) -> str:
        return _env("PADDLE_CURRENT_ENDPOINT", default="")


def sync_params_buffers(layer: Layer, group=None, src_rank: int = 0):
    """Every parameter and buffer of ``layer`` set to the global rank
    ``src_rank``'s (one broadcast each)."""
    if C.group_rank(group)[0] == 1:
        return
    for t in list(layer.parameters()) + list(layer.buffers()):
        C.broadcast(t, src_rank, group)


def _mark_averaged(p) -> None:
    """Remember that ``p``'s gradient, as it is now, holds the average."""
    g = p.grad._t
    p._dp_averaged = (weakref.ref(g), g._version)


def _averaged(p) -> bool:
    """Whether ``p``'s gradient was averaged and no backward has added
    to it since (an accumulation writes it in place, which moves its
    version, or replaces it)."""
    mark = getattr(p, "_dp_averaged", None)
    g = p.grad
    return (mark is not None and g is not None and mark[0]() is g._t
            and mark[1] == g._t._version)


def average_gradients(params, group, bucket_bytes: int = 25 << 20) -> None:
    """Replace the gradients of ``params`` by their average over
    ``group``, summed in buckets (``overlap.bucketed_psum``); gradients
    already averaged since their last backward are left as they are, so
    a second call changes nothing."""
    n, _ = C.group_rank(group)
    todo = [p for p in params if p.grad is not None and not _averaged(p)]
    if n == 1 or not todo:
        return
    grads = {f"{i:06d}": p.grad._t for i, p in enumerate(todo)}
    summed = bucketed_psum(grads, group, bucket_bytes)
    with torch.no_grad():
        for i, p in enumerate(todo):
            p.grad._t.copy_(summed[f"{i:06d}"].div_(n))
            _mark_averaged(p)


class DataParallel(Layer):
    """``layers`` trained data parallel over ``group`` (a ``Group``, an
    axis name of the topology, a process group, or None for the world):
    after ``loss.backward()`` every parameter's gradient is the average
    of the ranks'.  The ranks start from rank 0's parameters."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = group
        self.nranks = C.group_rank(group)[0]
        self._grad_sync = True
        self._pass = None
        if self.nranks == 1:
            return
        pg = C.resolve_group(group)
        sync_params_buffers(layers, group, dist.get_global_rank(pg, 0))
        params = [p for p in layers.parameters() if not p.stop_gradient]
        self._params = params
        order = params[::-1]
        self._buckets = [[order[i] for i in b] for b in plan_buckets(
            [p._t for p in order], int(comm_buffer_size * (1 << 20)),
            int(last_comm_buffer_size * (1 << 20)))]
        self._bucket_of = {}
        for b, ps in enumerate(self._buckets):
            for p in ps:
                self._bucket_of[id(p)] = b
        for p in params:
            p._t.register_post_accumulate_grad_hook(self._hook_for(p))

    # -- the reduction ------------------------------------------------------
    def _hook_for(self, p):
        def hook(_leaf):
            if not self._grad_sync:
                return
            if self._pass is None:
                self._start_pass()
            b = self._bucket_of[id(p)]
            left = self._pass["left"]
            left[b] -= 1
            if left[b] == 0:
                self._launch(self._pass, b)
        return hook

    def _start_pass(self):
        self._pass = {"left": [len(ps) for ps in self._buckets],
                      "flat": {}, "reducer": Reducer(self.group)}
        torch.autograd.Variable._execution_engine.queue_callback(
            self._finish_pass)

    def _launch(self, state, b):
        flat = torch.cat([p.grad._t.reshape(-1) for p in self._buckets[b]])
        state["flat"][b] = flat
        state["reducer"].start(flat)

    def _finish_pass(self):
        state, self._pass = self._pass, None
        try:
            for b, ps in enumerate(self._buckets):
                if b in state["flat"]:
                    continue
                missing = [p.name for p in ps if p.grad is None]
                if missing and not self.find_unused_parameters:
                    raise RuntimeError(
                        f"DataParallel: {missing} got no gradient in this "
                        f"backward; wrap with find_unused_parameters=True")
                for p in ps:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p._t)
                self._launch(state, b)
        finally:
            state["reducer"].wait_all()
        self._write_back(state["flat"])

    def _write_back(self, flats):
        with torch.no_grad():
            for b, flat in flats.items():
                flat.div_(self.nranks)
                ps = self._buckets[b]
                for p, piece in zip(ps, flat.split([p._t.numel()
                                                    for p in ps])):
                    p.grad._t.copy_(piece.view(p._t.shape))
                    _mark_averaged(p)

    def apply_collective_grads(self):
        """Average the gradients over the group where no hook has since
        their last backward (``average_gradients``): after a backward
        the hooks ran, it changes nothing, and calling it twice never
        divides twice."""
        if self.nranks > 1:
            average_gradients(self._params, self.group)

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside it accumulate local gradients without
        reducing them."""
        old, self._grad_sync = self._grad_sync, False
        try:
            yield
        finally:
            self._grad_sync = old

    # -- the wrapped layer ----------------------------------------------------
    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    @property
    def parameters_(self):
        return self._layers.parameters()
