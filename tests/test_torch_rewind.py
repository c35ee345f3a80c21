"""The port's anomaly rewind (``paddle_tpu_torch.runtime.rewind``) against
the reference's ``RewindGuard`` (``tests/test_elastic_reshard.py``'s
rewind tests).

The same training loop, a linear regression over ``DistributedBatchSampler``
batches with a NaN loss injected at step 5, runs once on the reference's
loader, checkpoint manager and guard, once on the port's (their own
``DataLoader``, ``CheckpointManager`` and ``RewindGuard``).  The consumed
sample ids are equal exactly, the weights' trajectory at rtol 1e-6 (both
run the same float32 numpy arithmetic), and the incident records' fields
(all but the time, rank and pid of the process) are equal.  Budget
exhaustion, a rewind with no checkpoint and the spike classification are
held to the reference's the same way.
"""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — registers the Tensor pytree
from paddle_tpu import io as jio
from paddle_tpu import runtime as jrt
from paddle_tpu.distributed import fault_tolerance as jft
from paddle_tpu_torch import flags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import runtime as trt
from paddle_tpu_torch.distributed import fault_tolerance as tft
from paddle_tpu_torch.profiler import metrics
from torch_data_helpers import ArrayDataset

PORT = (tio, tft, trt, lambda w: {"w": torch.from_numpy(w.copy())})
REF = (jio, jft, jrt, lambda w: {"w": w.copy()})


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _fields(recs, kind=None):
    return [{k: v for k, v in r.items() if k not in ("time", "rank", "pid")}
            for r in recs if kind is None or r["kind"] == kind]


def _setup(pkg, root, max_rewinds=2):
    io, ft, rt, _ = pkg
    ds = ArrayDataset(n=64)
    smp = io.DistributedBatchSampler(ds, 8, num_replicas=1, rank=0,
                                     shuffle=True, seed=11)
    loader = io.DataLoader(ds, batch_sampler=smp)
    mgr = ft.CheckpointManager(root, backend="pickle",
                               keep=3).attach_data(loader)
    guard = rt.RewindGuard(mgr, data=loader, max_rewinds=max_rewinds)
    return ds, smp, loader, mgr, guard


def _nan_loop(pkg, root):
    """NaN at step 5 -> restore step 4, skip the poisoned window, run on
    to step 6 (the reference test's loop)."""
    io, ft, rt, wrap = pkg
    rt.clear_incidents()
    ds, smp, loader, mgr, guard = _setup(pkg, root)
    lr, w = 0.05, np.zeros(4, np.float32)
    consumed, traj, step, it = [], [], 0, iter(loader)
    while step < 6:
        xs, ys, ids = (_np(b) for b in next(it))
        step += 1
        err = xs @ w - ys
        loss = float(np.mean(err ** 2))
        if step == 5 and guard.rewinds == 0:
            loss = float("nan")
        rw = guard.check(step, loss)
        if rw is not None:
            w, step = np.asarray(_np(rw.state["w"]), np.float32), rw.step
            it = iter(loader)
            continue
        w = w - lr * (2.0 * xs.T @ err / len(xs))
        consumed.extend(ids.astype(int).tolist())
        traj.append(w.copy())
        mgr.save(step, wrap(w))
    ft.unpin_step(mgr.root)
    return {"order": smp._global_order(0), "consumed": consumed,
            "traj": np.stack(traj), "incidents": _fields(rt.incidents())}


def test_nan_batch_loop_equals_reference(tmp_path):
    flags.set_flags({"FLAGS_tpu_metrics": True})
    metrics.reset()
    try:
        port = _nan_loop(PORT, str(tmp_path / "port"))
        snap = metrics.snapshot()
    finally:
        flags.set_flags({"FLAGS_tpu_metrics": False})
        metrics.reset()
    ref = _nan_loop(REF, str(tmp_path / "ref"))
    order = port["order"]
    assert order == ref["order"]
    assert port["consumed"] == ref["consumed"] == order[:32] + order[40:56]
    np.testing.assert_allclose(port["traj"], ref["traj"], rtol=1e-6)
    assert port["incidents"] == ref["incidents"]
    (rec,) = [r for r in port["incidents"] if r["kind"] == "anomaly_rewind"]
    assert rec["restored_step"] == 4 and rec["skipped_batches"] == 1
    assert snap["rewind_total"] == 1
    assert snap["rewind_skipped_batches_total"] == 1


def _budget(pkg, root):
    io, ft, rt, wrap = pkg
    rt.clear_incidents()
    _, _, _, mgr, guard = _setup(pkg, root, max_rewinds=1)
    mgr.save(1, wrap(np.zeros(4, np.float32)))
    rw = guard.rewind(3, loss=float("nan"), reason="nonfinite")
    with pytest.raises(rt.RewindBudgetExceeded, match="budget"):
        guard.check(4, float("inf"))
    ft.unpin_step(mgr.root)
    return (rw.step, rw.anomaly_step, rw.skipped_batches, rw.reason,
            guard.data.state_dict()), _fields(rt.incidents())


def test_budget_exhaustion_equals_reference(tmp_path):
    port = _budget(PORT, str(tmp_path / "port"))
    ref = _budget(REF, str(tmp_path / "ref"))
    assert port == ref
    assert port[0][:3] == (1, 3, 2)
    assert [r["kind"] for r in port[1]] == ["anomaly_rewind",
                                           "rewind_budget_exhausted"]


def _no_ckpt(pkg, root):
    io, ft, rt, _ = pkg
    rt.clear_incidents()
    _, _, _, mgr, guard = _setup(pkg, root)
    with pytest.raises(rt.RewindBudgetExceeded, match="NO"):
        guard.rewind(2, reason="nonfinite")
    return _fields(rt.incidents())


def test_rewind_without_checkpoint_equals_reference(tmp_path):
    port = _no_ckpt(PORT, str(tmp_path / "port"))
    assert port == _no_ckpt(REF, str(tmp_path / "ref"))
    assert port[-1]["kind"] == "rewind_failed"


@pytest.mark.parametrize("rt", [trt, jrt], ids=["port", "reference"])
def test_spike_classification(rt):
    guard = rt.RewindGuard(None, spike_factor=10.0, min_history=3)
    for v in (1.0, 1.1, 0.9):
        assert guard.classify(v) is None
        guard._history.append(v)
    assert guard.classify(5.0) is None
    assert guard.classify(50.0) == "spike"
    assert guard.classify(float("nan")) == "nonfinite"
    assert guard.classify("not-a-loss") is None
    assert guard.classify(torch.tensor(float("inf"))) == "nonfinite"
