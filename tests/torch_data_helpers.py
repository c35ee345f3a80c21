"""Datasets the port's data-pipeline tests hand to ``DataLoader`` worker
processes: numpy only, importable by a spawned worker without JAX."""
import numpy as np


class ArrayDataset:
    """(x, y, sample_id) triples over a deterministic regression set (the
    reference tests' ``_ArrayDataset``)."""

    def __init__(self, n=48, d=4, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, d)).astype(np.float32)
        w = rng.standard_normal((d,)).astype(np.float32)
        self.y = (self.x @ w).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i], np.int64(i)
