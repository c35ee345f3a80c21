"""Eager training example: LeNet on synthetic MNIST, on the port.

Run: python -m paddle_tpu_torch.examples.train_lenet  (on the card; pass
``--device cpu`` for the CPU)

The loop of the JAX package's ``examples/train_lenet.py``: Adam,
CrossEntropyLoss, 2 epochs of 15 steps at batch 64, with
``FLAGS_tpu_metrics`` on so each epoch prints the optimizer step and
data-wait latencies, and the per-step scalars going to
``runs/lenet_torch/scalars.jsonl`` through ``hapi.callbacks.ScalarLogger``.

Fault tolerance: a ``CheckpointManager(backend="pickle")`` commits every
10 steps under ``runs/lenet_torch/ckpt`` and the next run resumes from
the newest committed step.  The loader's cursor is in the checkpoint
(``attach_data``: the batches come in the order of a seeded
``DistributedBatchSampler``), and the optimizer's state is keyed by the
parameters' structured names, so a resumed run takes the batches and
makes the updates the uninterrupted run would have.

Precision on the card: torch's defaults, so the convolutions run in
TF32 (``torch.backends.cudnn.allow_tf32`` is True) and the linear
layers in full float32 (``torch.backends.cuda.matmul.allow_tf32`` is
False).
"""
import argparse
import os
import shutil
import time

EPOCHS = 2
STEPS_PER_EPOCH = 15
TOTAL_STEPS = EPOCHS * STEPS_PER_EPOCH
RUN_DIR = os.path.join("runs", "lenet_torch")
BATCH = 64


def _by_structure(net, opt_state):
    """The optimizer's state keyed by the parameters' structured names
    (``features.0.weight/moment1_0``), which do not depend on how many
    parameters the process made before this net."""
    names = sorted(((p.name, n) for n, p in net.named_parameters()),
                   key=lambda kv: -len(kv[0]))
    out = {}
    for k, v in opt_state.items():
        for pname, sname in names:
            if k.startswith(pname + "_"):
                out[sname + "/" + k[len(pname) + 1:]] = v
                break
        else:
            out[k] = v
    return out


def _by_name(net, state):
    """The inverse of ``_by_structure`` for this net's parameters."""
    names = {n: p.name for n, p in net.named_parameters()}
    out = {}
    for k, v in state.items():
        sname, sep, acc = k.partition("/")
        out[names[sname] + "_" + acc if sep else k] = v
    return out


def main(root=RUN_DIR, device=None, stop_after=None, verbose=True):
    """Train (or resume) the run in ``root``; on the card unless
    ``device`` names another ("cpu").  ``stop_after`` ends the run
    after that step, as a kill would.  Returns the losses by step, the
    step it resumed from, the host-clock ms of each step and the p50
    of the data wait."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.core.place import current_device
    from paddle_tpu_torch.distributed.fault_tolerance import CheckpointManager
    from paddle_tpu_torch.hapi.callbacks import ScalarLogger
    from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
    from paddle_tpu_torch.profiler import compile_tracker, metrics
    from paddle_tpu_torch.vision.datasets import MNIST

    say = print if verbose else (lambda *a, **k: None)
    paddle.set_device(device or "gpu")
    dev = current_device()
    prev_flags = paddle.get_flags(["FLAGS_tpu_metrics"])
    paddle.set_flags({"FLAGS_tpu_metrics": True})
    try:
        paddle.seed(0)
        net = paddle.vision.models.LeNet()
        opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                    parameters=net.parameters())
        loss_fn = nn.CrossEntropyLoss()
        ds = MNIST(backend="synthetic")
        loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
            ds, BATCH, num_replicas=1, rank=0, shuffle=True), places=dev)
        logger = ScalarLogger(root)
        ckpt_dir = os.path.join(root, "ckpt")

        def manager():
            return CheckpointManager(ckpt_dir, save_interval_steps=10,
                                     keep=2, backend="pickle"
                                     ).attach_data(loader)
        mgr = manager()
        ckpt, start = mgr.restore()
        if start >= TOTAL_STEPS:  # the previous run finished: start afresh
            shutil.rmtree(mgr.root)
            mgr = manager()
            ckpt, start = None, 0
            loader.batch_sampler.set_epoch(0)
            say("previous run complete; starting a fresh one")
        if ckpt is not None:
            net.set_state_dict(ckpt["net"])
            opt.set_state_dict(_by_name(net, ckpt["opt"]))
            say(f"resumed from committed step {start}")
        losses, step_ms = {}, []
        step = start
        it = iter(loader)
        for epoch in range(start // STEPS_PER_EPOCH, EPOCHS):
            for _ in range(step % STEPS_PER_EPOCH, STEPS_PER_EPOCH):
                img, label = (paddle.Tensor._wrap(t) for t in next(it))
                t0 = time.perf_counter()
                loss = loss_fn(net(img), paddle.reshape(label, [-1]))
                loss.backward()
                opt.step()
                opt.clear_grad()
                loss_v = float(loss.numpy())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                step += 1
                losses[step] = loss_v
                logger.log(step, loss=loss_v)
                mgr.step_end(step, {"net": net.state_dict(),
                                    "opt": _by_structure(
                                        net, opt.state_dict())})
                if stop_after is not None and step >= stop_after:
                    break
            snap = metrics.snapshot()
            step_lat = snap.get("optimizer_step_seconds", {})
            data_lat = snap.get("dataloader_next_seconds", {})
            say(f"epoch {epoch}: loss {losses[step]:.3f} | "
                f"steps {snap.get('optimizer_steps_total', 0):.0f} | "
                f"step p50 {step_lat.get('p50', 0) * 1e3:.1f} ms | "
                f"data wait p50 {data_lat.get('p50', 0) * 1e3:.1f} ms")
            if stop_after is not None and step >= stop_after:
                break
        logger.close()
        mgr.close()
        cs = compile_tracker.stats()
        say(f"kernel builds: {cs['compile_count']} "
            f"({cs['compile_seconds']:.2f} s)")
        say(f"scalars: {logger.path}")
        say(f"checkpoints: {ckpt_dir} (committed steps {mgr.all_steps()})")
        first, last = losses[min(losses)], losses[max(losses)]
        say(f"lenet: loss {first:.3f} -> {last:.3f}")
        return {"losses": losses, "resumed_from": start, "step_ms": step_ms,
                "data_wait_p50_ms": data_lat.get("p50", 0.0) * 1e3}
    finally:
        paddle.set_flags(prev_flags)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--root", default=RUN_DIR)
    a = ap.parse_args()
    out = main(root=a.root, device=a.device)
    ls = out["losses"]
    if out["resumed_from"] == 0:
        assert ls[max(ls)] < ls[min(ls)], "the loss did not fall"
