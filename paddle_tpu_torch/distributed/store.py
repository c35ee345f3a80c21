"""The rendezvous store and ``init_parallel_env`` (the port of
``paddle_tpu/distributed/store.py``'s ``TCPStore`` surface and of
``parallel.py``'s ``init_parallel_env``).

``TCPStore`` wraps ``torch.distributed.TCPStore`` (the reference's own
server, ``csrc/tcp_store.cc``, has no counterpart here).  It keeps the
reference's behaviour: values are bytes (other objects are pickled),
``get`` returns None for a missing key, client calls retry transient
socket failures with bounded exponential backoff and jitter
(``fault_tolerance.retry_with_backoff``, as in the reference), ``wait``
raises ``TimeoutError``, ``barrier`` names the ranks that never arrived
when it times out, and ``set``/``get``/``wait``/``add`` pass the
``store.<op>`` chaos points (inside the retry, so an injected
``disconnect`` is retried like a real one).  ``init_parallel_env``'s
``prefix`` keeps one generation's rendezvous keys apart from another's
on a store that outlives them (the launcher's).
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..testing.chaos import chaos_point
from .fault_tolerance import retry_with_backoff

__all__ = ["TCPStore", "init_parallel_env", "shutdown", "BACKENDS"]

# a failed connection or a dropped socket is worth another try; a wait
# that ran out of time is not
_TRANSIENT = (dist.DistNetworkError, ConnectionError, OSError)
_GIVE_UP = (TimeoutError, dist.DistStoreError)

# the backend each device type takes unless the caller names another
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _delta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStore:
    """``TCPStore(host, port, is_master, world_size, timeout)``: the
    master serves (``port=0`` picks a free port, read back from
    ``.port``), every other rank connects as a client.  ``_sleep`` and
    ``_retry_rng`` are injectable so tests can hold the retry schedule
    without waiting."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0, retries: int = 4,
                 retry_base_delay: float = 0.05,
                 retry_max_delay: float = 2.0):
        self.host = host
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.retries = int(os.environ.get("PTQ_STORE_RETRIES", retries))
        self.retry_base_delay = retry_base_delay
        self.retry_max_delay = retry_max_delay
        self._sleep = time.sleep
        self._retry_rng = None
        self._impl = self._with_retries("connect", lambda: dist.TCPStore(
            host, int(port), None, bool(is_master), _delta(timeout),
            wait_for_workers=False))
        self.port = self._impl.port

    @property
    def raw(self) -> dist.Store:
        """The torch store itself (what ``init_process_group`` takes)."""
        return self._impl

    def _with_retries(self, what: str, fn: Callable[[], Any]):
        def _on_retry(attempt, exc, delay):
            sys.stderr.write(
                f"TCPStore.{what}: transient failure ({exc}); retry "
                f"{attempt}/{self.retries - 1} in {delay:.2f}s\n")
            from ..profiler import metrics
            if metrics.enabled():
                metrics.counter("store_retry_total",
                                "TCPStore transient-error retries",
                                op=what).inc()

        return retry_with_backoff(
            fn, retryable=_TRANSIENT, give_up=_GIVE_UP,
            attempts=self.retries, base_delay=self.retry_base_delay,
            max_delay=self.retry_max_delay, sleep=self._sleep,
            rng=self._retry_rng, on_retry=_on_retry)

    def set(self, key: str, value) -> None:
        if not isinstance(value, (bytes, bytearray)):
            value = pickle.dumps(value)
        data = bytes(value)

        def _op():
            chaos_point("store.set", path=None, key=key)
            self._impl.set(key, data)
        self._with_retries("set", _op)

    def get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None when it is not set."""
        def _op():
            chaos_point("store.get", path=None, key=key)
            if not self._impl.check([key]):
                return None
            return self._impl.get(key)
        return self._with_retries("get", _op)

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        """Block until ``key`` exists, up to ``timeout`` (default: the
        store's), then return its value; ``TimeoutError`` past it."""
        budget = self.timeout if timeout is None else float(timeout)
        chaos_point("store.wait", path=None, key=key)
        try:
            self._impl.wait([key], _delta(budget))
        except dist.DistStoreError:
            raise TimeoutError(f"TCPStore.wait({key!r}) timed out after "
                               f"{budget:.1f}s") from None
        return self._impl.get(key)

    def get_obj(self, key: str, timeout: Optional[float] = None):
        # the store holds only what this program's ranks wrote
        return pickle.loads(self.wait(key, timeout))

    def add(self, key: str, delta: int = 1) -> int:
        def _op():
            chaos_point("store.add", path=None, key=key)
            return self._impl.add(key, delta)
        return self._with_retries("add", _op)

    def delete_key(self, key: str) -> bool:
        return self._impl.delete_key(key)

    def barrier(self, name: str = "barrier", rank: Optional[int] = None,
                timeout: Optional[float] = None):
        """Every one of ``world_size`` ranks blocks until all arrived.
        Each stamps an arrival key before it bumps the shared counter,
        so a timeout names the ranks that never came.  ``rank`` defaults
        to ``RANK`` (what ``torchrun`` sets), else ``PADDLE_TRAINER_ID``."""
        if rank is None:
            rank = int(os.environ.get(
                "RANK", os.environ.get("PADDLE_TRAINER_ID", "0")))
        self.set(f"__bar_in__{name}/{rank}", b"1")
        n = self.add(f"__bar__{name}", 1)
        if n == self.world_size:
            self.set(f"__bar_done__{name}", b"1")
        try:
            self.wait(f"__bar_done__{name}", timeout)
        except TimeoutError:
            missing = self.barrier_missing(name)
            budget = self.timeout if timeout is None else timeout
            from ..runtime.watchdog import record_incident
            record_incident("store_barrier_timeout", barrier=name,
                            rank=rank, world_size=self.world_size,
                            timeout_s=round(float(budget), 3),
                            missing=missing)
            raise TimeoutError(
                f"store barrier {name!r} timed out after {budget:.1f}s: "
                f"rank {rank} waited for {self.world_size} ranks but "
                f"ranks {missing} never arrived") from None

    def barrier_missing(self, name: str) -> list:
        """Ranks with no arrival stamp for barrier ``name`` (a diagnostic
        read: never raises)."""
        missing = []
        for r in range(self.world_size):
            try:
                if self.get(f"__bar_in__{name}/{r}") is None:
                    missing.append(r)
            except (*_TRANSIENT, *_GIVE_UP):
                missing.append(r)
        return missing

    def close(self):
        self._impl = None


def init_parallel_env(device=None, *, backend: Optional[str] = None,
                      store: Optional[TCPStore] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout: float = 300.0, prefix: str = "") -> TCPStore:
    """Join the process group and return the rendezvous store.

    Rank and world size come from the arguments, else from the
    launcher's environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT``/``LOCAL_RANK`` as ``torchrun`` sets them, or the
    ``PADDLE_*`` names), else a world of one.  ``device`` (the card
    unless the caller names another) fixes the backend: NCCL for CUDA,
    gloo for the CPU; ``backend`` names another explicitly (gloo over
    CUDA tensors runs several ranks on one card, which NCCL refuses).
    Every rank stamps a store barrier before the process group forms,
    so a rank that never starts is named in the error.  ``prefix``
    namespaces the barrier and the process group's keys (a relaunched
    generation on the same store passes its own)."""
    dev = resolve_device(device)
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", env.get("PADDLE_TRAINER_ID", "0")))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE",
                                 env.get("PADDLE_TRAINERS_NUM", "1")))
    if store is None:
        host = env.get("MASTER_ADDR", env.get("PADDLE_MASTER", "127.0.0.1"))
        port = int(env.get("MASTER_PORT", "0"))
        if world_size > 1 and not port:
            raise ValueError("a world of several ranks needs MASTER_PORT "
                             "(or a store)")
        # under torchrun's agent store every worker is a client
        master = (rank == 0
                  and env.get("TORCHELASTIC_USE_AGENT_STORE") != "True")
        store = TCPStore(host, port, master, world_size, timeout)
    backend = backend or BACKENDS[dev.type]
    device_id = None
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", env.get("PADDLE_LOCAL_RANK",
                                                  str(rank))))
        torch.cuda.set_device(local % torch.cuda.device_count())
        if backend == "nccl":
            device_id = torch.device("cuda", torch.cuda.current_device())
    store.barrier(f"{prefix}init_parallel_env", rank=rank, timeout=timeout)
    dist.init_process_group(backend,
                            store=dist.PrefixStore(f"{prefix}pg", store.raw),
                            rank=rank, world_size=world_size,
                            timeout=_delta(timeout), device_id=device_id)
    return store


def shutdown():
    """Leave the process group (the inverse of ``init_parallel_env``);
    a no-op when there is none."""
    from .mesh import set_topology
    set_topology(None)
    if dist.is_initialized():
        dist.destroy_process_group()
