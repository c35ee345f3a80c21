"""Run a function as every rank of a fresh world of processes on this
host (the counterpart of the reference's ``distributed.spawn``).

``spawn(fn, nprocs, args)`` serves a ``TCPStore`` from the calling
process, starts ``nprocs`` processes by the ``spawn`` method (fresh
interpreters: ``fn`` and its arguments are pickled, ``fn`` by import
path), and in each joins the process group through
``init_parallel_env`` before it calls ``fn(*args)``.  It returns the
ranks' results in rank order.  A rank that raises fails the call with
its traceback; a rank that dies, or a world that runs past ``timeout``,
fails it too, and every process is stopped before ``spawn`` returns or
raises.  Several cards take ``torchrun --nproc_per_node N`` instead,
whose ranks call ``init_parallel_env()`` themselves.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from ..device import resolve_device
from .store import TCPStore, init_parallel_env, shutdown

__all__ = ["spawn"]


def _rank_main(fn, rank, world, port, device, backend, args, timeout, out):
    try:
        store = TCPStore("127.0.0.1", port, False, world, timeout)
        init_parallel_env(device, backend=backend, store=store, rank=rank,
                          world_size=world, timeout=timeout)
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence = (), *,
          device=None, backend: Optional[str] = None,
          timeout: float = 300.0) -> List[Any]:
    """``fn(*args)`` on every rank of a new world of ``nprocs`` processes
    on ``device`` (the card unless the caller names another; rank ``r``
    takes card ``r`` modulo the cards there are), over ``backend``
    (default: the device's, NCCL or gloo; several ranks on one card take
    gloo).  Returns the results by rank."""
    dev = resolve_device(device).type
    store = TCPStore("127.0.0.1", 0, True, nprocs, timeout)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, store.port, dev, backend,
                               tuple(args), timeout, out))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(nprocs)) - set(results))
                raise TimeoutError(f"ranks {missing} of {nprocs} did not "
                                   f"finish within {timeout:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {nprocs} died with "
                                           f"exit code {p.exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == nprocs else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        store.close()
    return [results[r] for r in range(nprocs)]
