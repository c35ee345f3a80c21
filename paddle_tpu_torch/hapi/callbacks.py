"""hapi callbacks (the port of ``paddle_tpu/hapi/callbacks.py``):
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``,
``LRScheduler``, ``ScalarLogger`` (the same JSONL records) and
``VisualDL``, whose memory scalar reads the card's allocator through
``paddle_tpu_torch.device.memory_stats``."""
from __future__ import annotations


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0 and logs:
            print(f"step {step}: " + " ".join(
                f"{k}={v}" for k, v in logs.items()), flush=True)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.wait = 0
        self.best = None
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        if not logs or self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        improved = (self.best is None
                    or (self.mode == "min" and cur < self.best - self.min_delta)
                    or (self.mode == "max" and cur > self.best + self.min_delta))
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch


class ScalarWriter:
    """Append-only JSONL scalar log — the VisualDL LogWriter analog
    (reference: VisualDLCallback in python/paddle/hapi/callbacks.py:772
    writing via visualdl.LogWriter). JSONL instead of the VisualDL
    protobuf format: no service dependency, trivially consumed by pandas
    or a TensorBoard converter."""

    def __init__(self, logdir):
        import os
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.jsonl")
        self._f = open(self._path, "a", buffering=1)

    def add_scalar(self, tag, value, step):
        import json
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def close(self):
        self._f.close()


class ScalarLogger(Callback):
    """Per-step scalar + metrics-registry JSONL logger (the VisualDL
    `LogWriter` analogue for headless runs). Each record is one JSON
    object per line in ``<run_dir>/scalars.jsonl``:

        {"step": 7, "scalars": {"loss": 1.93, ...},
         "metrics": {...metrics.snapshot()...}}

    The ``metrics`` field is included when ``FLAGS_tpu_metrics`` is on
    (and ``with_metrics`` isn't False), so one file carries the loss
    curve AND the numerics telemetry (grad norms, loss scale, step
    latencies) — trivially consumed by pandas/jq or re-emitted to
    TensorBoard. Usable two ways: as a hapi callback (Model.fit), or
    directly from a manual loop via ``logger.log(step, loss=...)``.
    """

    def __init__(self, run_dir, log_freq=1, with_metrics=True):
        super().__init__()
        import os
        self.run_dir = run_dir
        self.log_freq = max(int(log_freq), 1)
        self.with_metrics = with_metrics
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "scalars.jsonl")
        self._f = None
        self._step = 0

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "a", buffering=1)
        return self._f

    def log(self, step, **scalars):
        """Append one record; non-numeric scalars are dropped."""
        import json
        clean = {}
        for k, v in scalars.items():
            if isinstance(v, (list, tuple)) and len(v) == 1:
                v = v[0]
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                pass
        record = {"step": int(step), "scalars": clean}
        if self.with_metrics:
            from ..profiler import metrics as _metrics
            if _metrics.enabled():
                record["metrics"] = _metrics.snapshot()
        self._file().write(json.dumps(record) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % self.log_freq == 0:
            self.log(self._step, **(logs or {}))

    def on_train_end(self, logs=None):
        self.close()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class VisualDL(Callback):
    """Scalar-logging callback (reference callbacks.py:772 VisualDL):
    records per-step train metrics and per-epoch eval metrics through
    ScalarWriter, plus device memory stats when the backend exposes
    them."""

    def __init__(self, log_dir="vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0

    def _w(self):
        if self._writer is None:
            self._writer = ScalarWriter(self.log_dir)
        return self._writer

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            try:
                self._w().add_scalar(f"train/{k}", float(v), self._step)
            except (TypeError, ValueError):
                pass
        try:
            from ..device import memory_stats
            stats = memory_stats() or {}
            if "bytes_in_use" in stats:
                self._w().add_scalar("sys/bytes_in_use",
                                     stats["bytes_in_use"], self._step)
        # best-effort: a telemetry miss (no card, say) must never fail
        # a train step
        except Exception:  # noqa: BLE001
            pass

    def on_epoch_end(self, epoch, logs=None):
        # epoch logs mix TRAIN epoch means with eval_* results; keep the
        # namespaces separate so eval curves really are eval
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)) and len(v) == 1:
                v = v[0]
            tag = (f"eval/{k[5:]}" if k.startswith("eval_")
                   else f"train_epoch/{k}")
            try:
                self._w().add_scalar(tag, float(v), epoch)
            except (TypeError, ValueError):
                pass

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
