"""The port's data pipeline (``paddle_tpu_torch.io``) against
``paddle_tpu.io``: samplers, the sample-exact cursor, the loader.

The same dataset (``tests/torch_data_helpers.py``: numpy triples of x, y
and the sample id) goes through both packages.  Every comparison is
exact: the sample ids of every batch for every ``(nranks, rank)`` with
nranks 1, 2 and 4, the cursors (``state_dict``) after every batch of an
epoch and after a resume at another world size, the batches' values.
Beside them, the counterparts of ``tests/test_elastic_reshard.py``'s
cursor tests on the port's own ``CheckpointManager``, ``DataLoader``
workers (spawned, shared-memory queues) against the single-process
loader, and ``DeviceDataLoader`` / ``stage_to_device`` on the CPU.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — registers the Tensor pytree
from paddle_tpu.io import dataloader as jdl
from paddle_tpu.io import dataset as jds
from paddle_tpu.io import sampler as jsmp
from paddle_tpu_torch.distributed import fault_tolerance as ft
from paddle_tpu_torch.io import (BatchSampler, ConcatDataset, DataLoader,
                                 DeviceDataLoader, DistributedBatchSampler,
                                 RandomSampler, SequenceSampler, Subset,
                                 SubsetRandomSampler, TensorDataset,
                                 WeightedRandomSampler, random_split,
                                 stage_to_device)
from torch_data_helpers import ArrayDataset


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# ---------------------------------------------------------------------------
# samplers: the same ids as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nranks", [1, 2, 4])
@pytest.mark.parametrize("shuffle,drop_last,n",
                         [(True, False, 48), (False, False, 45),
                          (True, True, 45)],
                         ids=["shuffle", "pad", "drop_last"])
def test_distributed_sampler_ids_equal_reference(nranks, shuffle, drop_last,
                                                 n):
    ds = ArrayDataset(n=n)
    for rank in range(nranks):
        kw = dict(num_replicas=nranks, rank=rank, shuffle=shuffle,
                  drop_last=drop_last, seed=3)
        mine = DistributedBatchSampler(ds, 8 // nranks, **kw)
        ref = jsmp.DistributedBatchSampler(ds, 8 // nranks, **kw)
        for epoch in range(2):
            assert mine._global_order(epoch) == ref._global_order(epoch)
            got, want = [], []
            rit = iter(ref)
            for a, b in zip(mine, rit):   # lockstep: the cursors too
                got.append(a)
                want.append(b)
                assert mine.state_dict() == ref.state_dict()
            assert next(rit, None) is None     # the epoch's end
            assert got == want and len(got) == len(ref) == len(mine)
            assert mine.state_dict() == ref.state_dict()


def test_cursor_resume_across_resize_equals_reference():
    """A cursor taken at 4 ranks mid-epoch, loaded at 2: the same ids and
    states as the reference's, and every sample once."""
    ds = ArrayDataset(n=48)
    kw = dict(shuffle=True, seed=5)
    mine4 = DistributedBatchSampler(ds, 2, num_replicas=4, rank=1, **kw)
    ref4 = jsmp.DistributedBatchSampler(ds, 2, num_replicas=4, rank=1, **kw)
    it_m, it_r = iter(mine4), iter(ref4)
    for _ in range(3):
        assert next(it_m) == next(it_r)
    st = mine4.state_dict()
    assert st == ref4.state_dict() and st["offset"] == 24
    order = mine4._global_order(0)
    rest = []
    for r in range(2):
        m = DistributedBatchSampler(ds, 4, num_replicas=2, rank=r, **kw)
        j = jsmp.DistributedBatchSampler(ds, 4, num_replicas=2, rank=r,
                                         **kw)
        m.load_state_dict(st)
        j.load_state_dict(st)
        got = list(m)
        assert got == list(j) and m.state_dict() == j.state_dict()
        rest.append(got)
    flat = [i for step in zip(*rest) for b in step for i in b]
    assert flat == order[24:]


def test_plain_samplers_equal_reference():
    ds = ArrayDataset(n=20)
    import paddle_tpu_torch.io.sampler as tsmp
    for make in (lambda m: m.SequenceSampler(ds),
                 lambda m: m.RandomSampler(ds),
                 lambda m: m.RandomSampler(ds, replacement=True,
                                           num_samples=7),
                 lambda m: m.SubsetRandomSampler(range(3, 15)),
                 lambda m: m.WeightedRandomSampler(np.arange(1, 21), 9),
                 lambda m: m.BatchSampler(ds, shuffle=True, batch_size=6),
                 lambda m: m.BatchSampler(ds, batch_size=6, drop_last=True)):
        np.random.seed(7)
        mine = make(tsmp)
        got = list(mine)
        np.random.seed(7)
        want = list(make(jsmp))
        assert got == want and len(mine) == len(got)
        assert isinstance(mine, (SequenceSampler, RandomSampler,
                                 SubsetRandomSampler, WeightedRandomSampler,
                                 BatchSampler))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def test_loader_batches_equal_reference():
    ds = ArrayDataset(n=40)
    kw = dict(num_replicas=2, rank=1, shuffle=True, seed=9)
    mine = DataLoader(ds, batch_sampler=DistributedBatchSampler(ds, 4, **kw))
    ref = jdl.DataLoader(ds, batch_sampler=jsmp.DistributedBatchSampler(
        ds, 4, **kw))
    n = 0
    rit = iter(ref)
    for a, b in zip(mine, rit):
        # numpy's collate dtypes (the JAX facade holds ids as int32)
        assert [t.dtype for t in a] == [torch.float32, torch.float32,
                                        torch.int64]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), _np(y))
        assert mine.state_dict() == ref.state_dict()
        n += 1
    assert next(rit, None) is None
    assert n == len(mine) == 5
    assert mine.state_dict() == ref.state_dict()


def test_loader_cursor_counts_consumed_batches():
    ds = ArrayDataset(n=48)
    smp = DistributedBatchSampler(ds, 8, num_replicas=1, rank=0,
                                  shuffle=True, seed=2)
    loader = DataLoader(ds, batch_sampler=smp)
    order = smp._global_order(0)
    it = iter(loader)
    for _ in range(3):
        next(it)
    st = loader.state_dict()
    assert st["offset"] == 24 and st["epoch"] == 0
    for _ in it:
        pass
    assert loader.state_dict() == smp.state_dict()
    assert loader.state_dict()["epoch"] == 1
    loader.load_state_dict(st)
    assert next(iter(loader))[2].tolist() == order[24:32]


def test_loader_cursor_exact_with_worker_runahead():
    """Workers take the whole epoch's batches at once; the cursor counts
    what the consumer took.  The batches equal the single-process
    loader's."""
    ds = ArrayDataset(n=32)
    smp = DistributedBatchSampler(ds, 8, num_replicas=1, rank=0,
                                  shuffle=True, seed=4)
    loader = DataLoader(ds, batch_sampler=smp, num_workers=1)
    it = iter(loader)
    first = next(it)
    assert smp.state_dict() == {"epoch": 1, "offset": 0, "seed": 4,
                                "shuffle": True, "global_batch_size": 8}
    assert loader.state_dict()["offset"] == 8
    assert loader.state_dict()["epoch"] == 0
    got = [first] + list(it)
    want = list(DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, 8, num_replicas=1, rank=0, shuffle=True, seed=4)))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_two_workers_keep_the_sampler_order():
    ds = ArrayDataset(n=40)
    got = [b[2].tolist() for b in DataLoader(ds, batch_size=4,
                                             num_workers=2)]
    assert got == [list(range(i, i + 4)) for i in range(0, 40, 4)]


def test_loader_state_requires_stateful_sampler():
    loader = DataLoader(ArrayDataset(n=8), batch_size=2)
    with pytest.raises(TypeError, match="state_dict"):
        loader.state_dict()
    with pytest.raises(TypeError, match="load_state_dict"):
        loader.load_state_dict({"offset": 0})


def test_manifest_replays_cursor_across_world_sizes(tmp_path):
    """The port's CheckpointManager: a cursor committed at nranks=4
    resumes sample-exact on a nranks=2 loader (same global batch)."""
    root = str(tmp_path / "ckpt")
    ds = ArrayDataset(n=48)
    smp4 = DistributedBatchSampler(ds, 2, num_replicas=4, rank=0,
                                   shuffle=True, seed=7)
    loader4 = DataLoader(ds, batch_sampler=smp4)
    mgr = ft.CheckpointManager(root, backend="pickle").attach_data(loader4)
    it = iter(loader4)
    next(it), next(it)
    mgr.save(2, {"w": torch.zeros(4)})
    man = ft.read_manifest(os.path.join(root, ft.step_dir_name(2)))
    assert man["data"] == {"epoch": 0, "offset": 16, "seed": 7,
                           "shuffle": True, "global_batch_size": 8}
    smp2 = DistributedBatchSampler(ds, 4, num_replicas=2, rank=0,
                                   shuffle=True, seed=0)
    loader2 = DataLoader(ds, batch_sampler=smp2)
    mgr2 = ft.CheckpointManager(root, backend="pickle").attach_data(loader2)
    state, got = mgr2.restore()
    assert got == 2 and state is not None
    order = smp2._global_order(0)    # the seed replayed from the manifest
    assert next(iter(loader2.batch_sampler)) == order[16:20]
    assert 2 in ft.pinned_steps(root)
    ft.unpin_step(root)


# ---------------------------------------------------------------------------
# datasets, collate, device staging
# ---------------------------------------------------------------------------

def test_datasets_and_collate():
    t = TensorDataset([torch.arange(6), torch.arange(6) * 10])
    assert [int(x) for x in t[2]] == [2, 20] and len(t) == 6
    c = ConcatDataset([t, Subset(t, [5, 4])])
    assert len(c) == 8 and [int(x) for x in c[7]] == [4, 40]
    np.random.seed(1)
    parts = random_split(t, [4, 2])
    np.random.seed(1)
    jparts = jds.random_split(list(range(6)), [4, 2])
    assert [p.indices for p in parts] == [p.indices for p in jparts]
    batch = DataLoader([{"a": np.float32(i), "b": [i, 2 * i]}
                        for i in range(4)], batch_size=4)
    (b,) = list(batch)
    assert b["a"].dtype == torch.float32 and b["b"][1].tolist() == [0, 2, 4,
                                                                    6]


def test_device_loader_and_staging_on_cpu():
    ds = ArrayDataset(n=16)
    base = DataLoader(ds, batch_size=4)
    staged = list(DeviceDataLoader(base, place="cpu", buffer_size=2))
    assert [b[2].tolist() for b in staged] == [
        list(range(i, i + 4)) for i in range(0, 16, 4)]
    assert len(DeviceDataLoader(base, place="cpu")) == 4
    out = stage_to_device({"x": np.ones(3, np.float32), "n": 3,
                           "t": (torch.zeros(2),)}, "cpu")
    assert torch.is_tensor(out["x"]) and out["n"] == 3
    assert out["t"][0].device.type == "cpu"
    loader = DataLoader(ds, batch_size=8, places="cpu")
    assert [b[2].tolist() for b in loader] == [list(range(8)),
                                               list(range(8, 16))]
    with pytest.raises(ValueError, match="buffer_size"):
        DeviceDataLoader(base, place="cpu", buffer_size=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceDataLoader(base)
