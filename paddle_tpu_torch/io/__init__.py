"""The data pipeline (the port of ``paddle_tpu/io``).

Datasets whose leaves are torch tensors (``dataset``), the samplers with
the sample-exact cursor of ``DistributedBatchSampler`` (``sampler``),
``DataLoader`` with worker processes that hand their batches over
``torch.multiprocessing`` queues in shared memory (``dataloader``), and
``DeviceDataLoader``, which copies batches from pinned host memory onto
the card on a side stream of its own, ``buffer_size`` batches ahead of
the step (``device_loader``).
"""
from .dataset import (Dataset, IterableDataset, TensorDataset, ComposeDataset,
                      ChainDataset, Subset, ConcatDataset, random_split)
from .sampler import (Sampler, SequenceSampler, RandomSampler,
                      WeightedRandomSampler, BatchSampler,
                      DistributedBatchSampler, SubsetRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .device_loader import DeviceDataLoader, stage_to_device

__all__ = ["DeviceDataLoader", "stage_to_device",
           "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "ConcatDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "SubsetRandomSampler", "DataLoader",
           "default_collate_fn", "get_worker_info"]
