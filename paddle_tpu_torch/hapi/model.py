"""The high-level ``Model`` API (the port of
``paddle_tpu/hapi/model.py``): ``prepare``, ``train_batch`` /
``eval_batch`` / ``predict_batch``, ``fit`` (``num_iters``,
``accumulate_grad_batches``, ``handle_preemption``), ``evaluate``,
``predict``, ``save`` / ``load`` and ``summary``.

Batches from a ``DataLoader`` arrive as torch tensors on the host; each
goes to the current place (the card unless ``set_device`` names
another) before the network sees it.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..core.place import current_device
from ..core.tensor import Tensor, to_tensor, no_grad
from ..metric import Metric

__all__ = ["Model", "summary"]


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks or []

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for cb in self.callbacks:
                if hasattr(cb, name):
                    getattr(cb, name)(*args, **kwargs)
        return call


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        return self

    # -- single-step APIs --------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._as_list(inputs)
        labels = self._as_list(labels)
        outputs = self.network(*inputs)
        losses = self._compute_loss(outputs, labels)
        total = losses[0] if len(losses) == 1 else sum(losses[1:], losses[0])
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss_vals = [float(l.item()) for l in losses]
        self._record_train_loss(loss_vals)
        return (loss_vals, metrics) if metrics else loss_vals

    @staticmethod
    def _record_train_loss(loss_vals):
        """Loss telemetry + tensor-checker step advance. Disabled path:
        two dict lookups."""
        from ..amp import debugging as _debugging
        _debugging.advance_step()
        from ..profiler import metrics as _metrics
        if not _metrics.enabled():
            return
        import math
        total = float(sum(loss_vals))
        _metrics.counter("train_batches_total",
                         "train_batch calls").inc()
        _metrics.gauge("train_loss", "Last train_batch total loss"
                       ).set(total)
        from ..profiler import numerics as _numerics
        _numerics.note("train_loss", total)
        if not math.isfinite(total):
            _metrics.counter("nonfinite_loss_steps_total",
                             "train_batch steps with NaN/Inf loss").inc()
            _numerics.record_site(
                "hapi.train_batch:loss", True,
                {"nan": int(math.isnan(total)),
                 "inf": int(math.isinf(total)), "size": len(loss_vals),
                 "shape": (len(loss_vals),), "dtype": "float32"})

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._as_list(inputs)
        labels = self._as_list(labels)
        outputs = self.network(*inputs)
        losses = self._compute_loss(outputs, labels)
        metrics = self._update_metrics(outputs, labels)
        loss_vals = [float(l.item()) for l in losses]
        return (loss_vals, metrics) if metrics else loss_vals

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._as_list(inputs)
        outputs = self.network(*inputs)
        return [o.numpy() if isinstance(o, Tensor) else o
                for o in self._as_list(outputs)]

    # -- loops -------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            handle_preemption=False):
        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers) if eval_data is not None \
            else None
        cbs = CallbackList(callbacks)
        for cb in cbs.callbacks:
            cb.set_model(self)
            cb.set_params({"epochs": epochs, "batch_size": batch_size,
                           "verbose": verbose, "metrics": [
                               m.name() for m in self._metrics]})
        history = {"loss": []}
        self.stop_training = False
        it = 0
        # opt-in preemption contract (fleet/elastic exit-101 protocol):
        # SIGTERM/SIGINT finishes the current batch, saves a final
        # checkpoint into save_dir, and exits RELAUNCH_EXIT_CODE so an
        # elastic supervisor respawns the job for free
        preempt = None
        if handle_preemption:
            from ..distributed.fault_tolerance import PreemptionHandler
            preempt = PreemptionHandler()
        cbs.on_train_begin()
        try:
            self._fit_loop(loader, eval_loader, epochs, eval_freq,
                           save_dir, save_freq, verbose, log_freq,
                           accumulate_grad_batches, num_iters, history,
                           cbs, preempt)
        finally:
            if preempt is not None:
                preempt.uninstall()
            cbs.on_train_end({"loss": history["loss"][-1]
                              if history["loss"] else None})
        return history

    def _metric_logs(self):
        logs = {}
        for m in self._metrics:
            name, val = m.name(), m.accumulate()
            if isinstance(name, (list, tuple)):  # multi-topk Accuracy
                vals = val if isinstance(val, (list, tuple)) \
                    else [val] * len(name)
                logs.update(dict(zip(name, vals)))
            else:
                logs[name] = val
        return logs

    def _preempt_exit(self, preempt, save_dir, verbose):
        """Final synchronous checkpoint, then exit 101 for relaunch."""
        if save_dir is not None:
            self.save(f"{save_dir}/preempted")
        if verbose:
            print("preemption: checkpoint saved, exiting for relaunch",
                  flush=True)
        preempt.exit_for_relaunch()  # raises SystemExit(101)

    def _fit_loop(self, loader, eval_loader, epochs, eval_freq, save_dir,
                  save_freq, verbose, log_freq, accumulate_grad_batches,
                  num_iters, history, cbs, preempt=None):
        it = 0
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbs.on_epoch_begin(epoch)
            t0 = time.time()
            epoch_losses = []
            for step, batch in enumerate(loader):
                cbs.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                res = self.train_batch(ins, labs,
                                       update=(step + 1)
                                       % accumulate_grad_batches == 0)
                loss_vals = res[0] if isinstance(res, tuple) else res
                epoch_losses.append(loss_vals[0])
                it += 1
                logs = {"loss": float(loss_vals[0])}
                logs.update(self._metric_logs())
                cbs.on_train_batch_end(step, logs)
                if preempt is not None and preempt.requested():
                    self._preempt_exit(preempt, save_dir, verbose)
                if verbose and step % log_freq == 0:
                    msg = (f"Epoch {epoch + 1}/{epochs} step {step} "
                           f"loss: {loss_vals[0]:.4f}")
                    for m in self._metrics:
                        msg += f" {m.name()}: {self._fmt(m.accumulate())}"
                    print(msg, flush=True)
                if num_iters is not None and it >= num_iters:
                    break
            if hasattr(self._optimizer, "_lr") and hasattr(
                    self._optimizer._lr, "step"):
                self._optimizer._lr.step()
            history["loss"].append(float(np.mean(epoch_losses)))
            epoch_logs = {"loss": history["loss"][-1]}
            epoch_logs.update(self._metric_logs())
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_res = self.evaluate(eval_loader, verbose=verbose)
                if isinstance(eval_res, dict):
                    epoch_logs.update({
                        f"eval_{k}": (v[0] if isinstance(v, (list, tuple))
                                      and len(v) == 1 else v)
                        for k, v in eval_res.items()})
            cbs.on_epoch_end(epoch, epoch_logs)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            if verbose:
                print(f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s "
                      f"mean loss {history['loss'][-1]:.4f}", flush=True)
            if self.stop_training:  # EarlyStopping contract
                break
            if num_iters is not None and it >= num_iters:
                break

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            loss_vals = res[0] if isinstance(res, tuple) else res
            losses.append(loss_vals[0])
        out = {"loss": [float(np.mean(losses))] if losses else [0.0]}
        for m in self._metrics:
            out[m.name() if isinstance(m.name(), str) else
                m.name()[0]] = m.accumulate()
        if verbose:
            print("Eval " + " ".join(f"{k}: {v}" for k, v in out.items()),
                  flush=True)
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as fsave
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        self.network.set_state_dict(fload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None:
            import os
            if os.path.exists(path + ".pdopt"):
                self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _as_list(x):
        if x is None:
            return []
        return list(x) if isinstance(x, (list, tuple)) else [x]

    @staticmethod
    def _fmt(v):
        if isinstance(v, (list, tuple)):
            return "/".join(f"{x:.4f}" for x in v)
        return f"{v:.4f}"

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io import DataLoader, Dataset
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data  # assume iterable of batches

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return self._to_tensors(batch[:-1]), \
                    self._to_tensors([batch[-1]])
            return self._to_tensors(batch), []
        return self._to_tensors([batch]), []

    @staticmethod
    def _to_tensors(items):
        dev = current_device()
        out = []
        for x in items:
            if isinstance(x, Tensor):
                out.append(x)
            elif torch.is_tensor(x):
                out.append(Tensor._wrap(x.to(dev, non_blocking=True)))
            else:
                out.append(to_tensor(np.asarray(x)))
        return out

    def _compute_loss(self, outputs, labels):
        outs = self._as_list(outputs)
        if self._loss is None:
            return [outs[0]]
        loss = self._loss(*(outs + labels))
        return self._as_list(loss)

    def _update_metrics(self, outputs, labels):
        outs = self._as_list(outputs)
        res = []
        for m in self._metrics:
            state = m.compute(*(outs + labels))
            r = m.update(*(state if isinstance(state, (list, tuple))
                           else [state]))
            res.append(r)
        return res


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """paddle.summary parity — parameter table + count."""
    lines = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not p.stop_gradient:
            trainable += n
        lines.append(f"{name:60s} {str(p.shape):24s} {n:>12,d}")
    report = "\n".join(lines)
    report += (f"\nTotal params: {total:,}\nTrainable params: {trainable:,}"
               f"\nNon-trainable params: {total - trainable:,}")
    print(report, flush=True)
    return {"total_params": total, "trainable_params": trainable}
