"""DataLoader (the port of ``paddle_tpu/io/dataloader.py``).

Batches come from the batch sampler in order.  With ``num_workers`` > 0
they are collated in worker processes, which hand them back over a
``torch.multiprocessing`` queue: the tensors of a batch travel in shared
memory, not through a pipe (the reference's workers use its C++
``ShmQueue``).  Workers start by the ``spawn`` method, whose children
re-import ``__main__`` (a script that iterates such a loader at module
level needs the ``if __name__ == "__main__"`` guard); a dataset or
collate function that cannot be pickled falls back to ``fork`` with a
warning.  Workers never claim a card: they start with
``CUDA_VISIBLE_DEVICES`` empty.

The resume cursor (``state_dict``) counts the batches handed to the
consumer, not the ones dispatched to workers, so it is exact however far
the workers ran ahead.  ``places=`` hands the batches to a
``DeviceDataLoader`` (``device_loader.py``).
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "WorkerInfo"]

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def get_worker_info():
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Stack a list of samples into torch tensors, recursing through
    dicts, lists and tuples; numbers keep numpy's dtypes (int64,
    float64), strings stay lists."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (np.ndarray, np.generic)):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(t)) for t in transposed)
    return batch


def _to_tensor_tree(data):
    if isinstance(data, np.ndarray):
        return torch.from_numpy(data)
    if isinstance(data, dict):
        return {k: _to_tensor_tree(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_to_tensor_tree(v) for v in data)
    return data


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, base_seed, init_fn=None):
    torch.set_num_threads(1)
    _worker_info.info = WorkerInfo(worker_id, num_workers, dataset,
                                   base_seed + worker_id)
    np.random.seed(base_seed + worker_id)
    if init_fn is not None:
        init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            samples = [dataset[i] for i in indices]
            data_queue.put((batch_id, collate_fn(samples), None))
        except Exception as e:  # the consumer re-raises it
            data_queue.put((batch_id, None, e))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.places = places if isinstance(places, (list, tuple, type(None))) \
            else [places]
        self.use_buffer_reader = use_buffer_reader
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self._is_iterable = isinstance(dataset, IterableDataset)
        # the cursor: the sampler state at epoch start plus the batches
        # handed to the consumer since (state_dict)
        self._active_state = None
        self._yielded = 0
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif not self._is_iterable:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._is_iterable:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def __iter__(self):
        if self.batch_sampler is not None and \
                hasattr(self.batch_sampler, "state_dict"):
            # snapshot BEFORE any dispatch: _iter_multi runs the sampler
            # to the epoch's end at once for its workers
            self._active_state = dict(self.batch_sampler.state_dict())
            self._yielded = 0
        if self._is_iterable:
            it = self._iter_iterable()
        elif self.num_workers == 0:
            it = self._iter_single()
        else:
            it = self._iter_multi()
        if self.places:
            if len(self.places) > 1:
                raise ValueError(
                    "multi-place DataLoader output is not supported: one "
                    "process drives one card; data parallelism is one "
                    "process a rank, each with its DistributedBatchSampler")
            from .device_loader import DeviceDataLoader
            buf = self.prefetch_factor if self.use_buffer_reader else 1
            it = iter(DeviceDataLoader(it, self.places[0], buffer_size=buf))
        return self._instrumented(it)

    def _instrumented(self, it):
        """A ``dataloader_next`` span around each next batch when a
        Profiler is live, and the ``dataloader_next_seconds`` histogram
        and batch counter when FLAGS_tpu_metrics is on: the consumer's
        wait, near zero while the workers keep ahead.  Also where the
        cursor counts: a batch is consumed when it is handed over."""
        from ..profiler import _record_span, metrics as _metrics
        try:
            while True:
                rec = _metrics.enabled()
                t0 = time.perf_counter() if rec else None
                try:
                    with _record_span("dataloader_next"):
                        batch = next(it)
                except StopIteration:
                    self._active_state = None  # the epoch ran out
                    return
                if rec:
                    _metrics.counter("dataloader_batches_total",
                                     "Batches yielded by DataLoader").inc()
                    _metrics.histogram(
                        "dataloader_next_seconds",
                        "Consumer-side wait per batch").observe(
                            time.perf_counter() - t0)
                self._yielded += 1
                yield batch
        finally:
            # a consumer that breaks early stops the workers now, not at
            # garbage collection
            close = getattr(it, "close", None)
            if close is not None:
                close()

    # -- sample-exact resume ------------------------------------------------
    def state_dict(self) -> dict:
        """The cursor (epoch, consumed global sample offset, shuffle
        seed), exact mid-epoch: the sampler state at the epoch's start
        advanced by the batches handed to the consumer.  Needs a batch
        sampler with ``state_dict`` (``DistributedBatchSampler``)."""
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "state_dict"):
            raise TypeError(
                "DataLoader.state_dict needs a batch_sampler exposing "
                "state_dict/load_state_dict (io.DistributedBatchSampler); "
                f"got {type(bs).__name__}")
        if self._active_state is None:
            return dict(bs.state_dict())
        st = dict(self._active_state)
        gbs = int(st.get("global_batch_size",
                         getattr(bs, "global_batch_size", self.batch_size)))
        st["offset"] = int(st.get("offset", 0)) + self._yielded * gbs
        return st

    def load_state_dict(self, state: dict):
        """Resume the sampler from a cursor (valid across a dp resize:
        offsets are in global sample order)."""
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "load_state_dict"):
            raise TypeError(
                "DataLoader.load_state_dict needs a batch_sampler exposing "
                "state_dict/load_state_dict (io.DistributedBatchSampler); "
                f"got {type(bs).__name__}")
        bs.load_state_dict(dict(state))
        self._active_state = None
        self._yielded = 0

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield _to_tensor_tree(self.collate_fn(batch))
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield _to_tensor_tree(self.collate_fn(batch))

    def _iter_single(self):
        for indices in self.batch_sampler:
            samples = [self.dataset[i] for i in indices]
            yield _to_tensor_tree(self.collate_fn(samples))

    def _start_context(self):
        """The workers' start method, picked once: spawn, unless the
        payload cannot be pickled or ``__main__`` has no file to
        re-import (then fork, with a warning)."""
        if getattr(self, "_mp_ctx", None) is not None:
            return self._mp_ctx
        import os
        import pickle
        import sys
        import warnings

        import torch.multiprocessing as tmp

        class _NullWriter:
            def write(self, _):
                pass

        reason = None
        main_file = getattr(sys.modules.get("__main__"), "__file__", None)
        if main_file is not None and not os.path.exists(main_file):
            reason = (f"__main__ has no importable file ({main_file!r}; "
                      "stdin/exec script)")
        if reason is None:
            try:
                pickle.Pickler(_NullWriter(), pickle.HIGHEST_PROTOCOL).dump(
                    (self.dataset, self.collate_fn, self.worker_init_fn))
            except Exception:
                reason = "worker payload is not picklable"
        if reason is None:
            self._mp_ctx = tmp.get_context("spawn")
        else:
            warnings.warn(
                f"DataLoader: {reason}; falling back to fork workers. "
                "Forking a process that has initialised CUDA is safe only "
                "while the workers touch no card — run from a script file "
                "with the dataset and collate_fn at module scope to get "
                "spawn workers.", RuntimeWarning, stacklevel=3)
            self._mp_ctx = tmp.get_context("fork")
        return self._mp_ctx

    def _iter_multi(self):
        import os
        ctx = self._start_context()
        index_queues = []
        data_queue = ctx.Queue()
        workers = []
        base_seed = np.random.randint(0, 2 ** 31 - 1)
        # children inherit os.environ as of start(): hide the cards
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for wid in range(self.num_workers):
                iq = ctx.Queue()
                w = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, iq, data_queue, self.collate_fn, wid,
                          self.num_workers, base_seed, self.worker_init_fn),
                    daemon=True)
                w.start()
                workers.append(w)
                index_queues.append(iq)
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

        def recv():
            # poll in short waits: a worker that died (a bad __main__
            # under spawn, killed, crashed) must surface as an error, not
            # as a wait on an empty queue for ever
            deadline = (time.monotonic() + self.timeout) if self.timeout \
                else None
            while True:
                try:
                    return data_queue.get(timeout=0.2)
                except queue_mod.Empty:
                    pass
                dead = {i for i, w in enumerate(workers) if not w.is_alive()}
                # batch i belongs to worker i % N: a worker that died
                # after its share stalls nothing
                if dead and any((i % self.num_workers) in dead
                                for i in range(next_yield, next_dispatch)
                                if i not in reorder):
                    grace_end = time.monotonic() + min(
                        self.timeout or 5.0, 10.0)
                    if deadline is not None:
                        grace_end = min(grace_end, deadline)
                    while True:
                        try:
                            return data_queue.get(timeout=0.5)
                        except queue_mod.Empty:
                            if time.monotonic() < grace_end:
                                continue
                            dw = [workers[i] for i in sorted(dead)]
                            raise RuntimeError(
                                "DataLoader worker(s) "
                                f"{[w.pid for w in dw]} exited unexpectedly "
                                f"(exitcodes {[w.exitcode for w in dw]}) "
                                "with batches still pending") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"DataLoader timed out after {self.timeout}s "
                        "waiting for a worker batch")

        next_dispatch = next_yield = 0
        reorder = {}
        try:
            batches = list(self.batch_sampler)
            inflight = 0
            max_inflight = self.num_workers * self.prefetch_factor
            while next_yield < len(batches):
                while next_dispatch < len(batches) and inflight < max_inflight:
                    index_queues[next_dispatch % self.num_workers].put(
                        (next_dispatch, batches[next_dispatch]))
                    next_dispatch += 1
                    inflight += 1
                bid, data, err = recv()
                if err is not None:
                    raise err
                inflight -= 1
                reorder[bid] = data
                while next_yield in reorder:
                    yield _to_tensor_tree(reorder.pop(next_yield))
                    next_yield += 1
        finally:
            for iq in index_queues:
                iq.put(None)
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()
                    w.join()
