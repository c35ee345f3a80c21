"""Samplers (the port of ``paddle_tpu/io/sampler.py``).

The orders come from numpy's generators, as the reference's do, so both
packages draw the same sample ids from the same seed.  A
``DistributedBatchSampler`` without ``num_replicas``/``rank`` takes them
from ``torch.distributed`` (a world of one when there is no process
group)."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Per-rank batches of one global sample order.

    Epoch ``e``'s order is ``RandomState(seed + e).permutation`` (or
    ``arange`` without ``shuffle``), cut into global batches of
    ``nranks * batch_size``; rank ``r`` takes the slice ``[r *
    batch_size, (r + 1) * batch_size)`` of each.  The cursor
    (``state_dict``) is one global sample offset, the consumed prefix of
    the epoch's order, so a cursor written at world size N resumes at
    world size M without a sample replayed or skipped, as long as the
    global batch size stays the same."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            world, me = _world()
            num_replicas = world if num_replicas is None else num_replicas
            rank = me if rank is None else rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.seed = int(seed)
        self.epoch = 0
        self._offset = 0  # global samples consumed in the current epoch
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    @property
    def global_batch_size(self):
        return self.batch_size * self.nranks

    def _global_order(self, epoch):
        """Epoch ``epoch``'s global sample order, padded (wrapping) to a
        whole number of global batches, or cut under ``drop_last``."""
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + int(epoch))
            order = rng.permutation(n).tolist()
        else:
            order = list(range(n))
        gbs = self.global_batch_size
        if self.drop_last:
            return order[:(n // gbs) * gbs]
        pad = (-n) % gbs
        while pad > 0:
            take = min(pad, n)
            order += order[:take]
            pad -= take
        return order

    def __iter__(self):
        epoch = self.epoch
        order = self._global_order(epoch)
        gbs = self.global_batch_size
        lo = self.local_rank * self.batch_size
        g0 = self._offset
        while g0 < len(order):
            chunk = order[g0:g0 + gbs]
            g0 = min(g0 + gbs, len(order))
            # the cursor advances as batches are handed out: a state_dict
            # taken after training on batch b resumes at b + 1
            self._offset = g0
            batch = chunk[lo:lo + self.batch_size]
            if batch:
                yield batch
        self._offset = 0
        if self.shuffle:
            self.epoch = epoch + 1

    def __len__(self):
        n = len(self.dataset)
        gbs = self.global_batch_size
        if self.drop_last:
            return n // gbs
        return (n + gbs - 1) // gbs

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
        self._offset = 0

    # -- sample-exact resume ------------------------------------------------
    def state_dict(self):
        """The cursor: epoch, the consumed global sample offset and the
        shuffle's seed (the order is a function of ``seed + epoch``).
        JSON-able: ``CheckpointManager.attach_data`` puts it in every
        commit manifest."""
        return {"epoch": int(self.epoch), "offset": int(self._offset),
                "seed": int(self.seed), "shuffle": bool(self.shuffle),
                "global_batch_size": int(self.global_batch_size)}

    def load_state_dict(self, state):
        """Resume from a cursor, possibly written at another world size:
        the offset is global, so only the global batch size must stay."""
        self.epoch = int(state.get("epoch", 0))
        self._offset = int(state.get("offset", 0))
        if "seed" in state:
            self.seed = int(state["seed"])
