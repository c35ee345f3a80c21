"""``paddle.distributed.spawn`` (the port of
``paddle_tpu/distributed/launch_utils.py``) over the port's one-host
launcher, ``launch.spawn``.

``spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options)``
runs ``func(*args)`` on ``nprocs`` fresh processes (-1: one a card)
that have joined one process group, each with the launcher's
environment set as Paddle's is (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_RANK_IN_NODE``),
and returns their results by rank; ``join=False`` returns a context
whose ``join()`` waits for them.  ``options``: ``device`` (the card
unless the caller names another), ``backend``, ``timeout``.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools
import os

from . import launch

__all__ = ["spawn"]


def _with_env(func, rank, nprocs, args):
    for k in ("PADDLE_TRAINER_ID", "PADDLE_LOCAL_RANK",
              "PADDLE_RANK_IN_NODE"):
        os.environ[k] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    return func(*args)


def _rank_entry(func, nprocs, args):
    import torch.distributed as dist
    return _with_env(func, dist.get_rank(), nprocs, args)


class _Context:
    """What ``spawn(..., join=False)`` returns."""

    def __init__(self, future):
        self._future = future

    def join(self, timeout=None):
        return self._future.result(timeout)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    args = tuple(args or ())
    if nprocs == -1:
        import torch
        nprocs = max(1, torch.cuda.device_count())
    run = functools.partial(
        launch.spawn, _rank_entry, nprocs, (func, nprocs, args),
        **{k: options[k] for k in ("device", "backend", "timeout")
           if k in options})
    if join:
        return run()
    pool = cf.ThreadPoolExecutor(1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return _Context(fut)
