"""The port's LeNet example (``paddle_tpu_torch/examples/train_lenet.py``)
on the CPU: 30 steps in which the loss falls, and a run cut after its
committed step 20 that resumes there and gives the uninterrupted run's
losses bit for bit (the loader's cursor and the optimizer's state come
back with the checkpoint)."""
import json

import numpy as np

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.examples import train_lenet


def test_lenet_example_trains_and_resumes_bit_identically(tmp_path):
    full = train_lenet.main(root=str(tmp_path / "full"), device="cpu",
                            verbose=False)
    losses = full["losses"]
    assert full["resumed_from"] == 0
    assert sorted(losses) == list(range(1, 31))
    assert np.mean([losses[s] for s in range(26, 31)]) < \
        np.mean([losses[s] for s in range(1, 6)])
    assert all(np.isfinite(list(losses.values())))
    with open(tmp_path / "full" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(1, 31))
    assert recs[-1]["scalars"]["loss"] == losses[30]
    assert "metrics" in recs[-1]            # FLAGS_tpu_metrics was on
    assert not tpaddle.get_flags(["FLAGS_tpu_metrics"])["FLAGS_tpu_metrics"]

    cut = tmp_path / "cut"
    first = train_lenet.main(root=str(cut), device="cpu", stop_after=23,
                             verbose=False)
    assert sorted(first["losses"]) == list(range(1, 24))
    resumed = train_lenet.main(root=str(cut), device="cpu", verbose=False)
    assert resumed["resumed_from"] == 20
    assert sorted(resumed["losses"]) == list(range(21, 31))
    for s in range(1, 24):
        assert first["losses"][s] == losses[s], s
    for s in range(21, 31):
        assert resumed["losses"][s] == losses[s], s
    # a finished run starts afresh
    again = train_lenet.main(root=str(cut), device="cpu", verbose=False)
    assert again["resumed_from"] == 0
    assert again["losses"] == losses
