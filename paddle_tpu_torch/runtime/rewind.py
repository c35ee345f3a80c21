"""Anomaly rewind: roll a diverging run back to the last good commit (the
port of ``paddle_tpu/runtime/rewind.py``).

Loss spikes and NaN batches are routine events of a long training run,
to be recovered from: restore the last checkpoint and skip the data
window that poisoned the run.  :class:`RewindGuard` does that on top of
the crash-consistent checkpoint layer:

* **detect** — a non-finite loss (the numerics watchdog's territory —
  ``profiler.numerics`` supplies blame when enabled) or a spike above
  ``spike_factor`` x the recent healthy median;
* **rewind** — restore the newest committed step through the
  :class:`~..distributed.fault_tolerance.CheckpointManager` (which
  pins it as the keep-anchor and replays sampler/RNG state from the
  manifest);
* **skip** — advance the attached data pipeline past the whole window
  of batches consumed since that checkpoint (+ ``skip_extra``), so the
  relaunch does not re-eat the batch that poisoned the run;
* **account** — a structured ``anomaly_rewind`` incident in the runtime
  health buffer, plus ``rewind_total`` / ``rewind_skipped_batches_total``
  metrics (with FLAGS_tpu_metrics on);
* **bound** — at most ``max_rewinds`` rewinds per guard: a persistent
  divergence raises :class:`RewindBudgetExceeded` instead of
  livelocking the job.

Typical loop::

    guard = RewindGuard(mgr, data=loader, max_rewinds=2)
    state, start = mgr.restore(target)
    for step, batch in stepper:
        state, loss = train_step(state, batch)
        rw = guard.check(step, loss)
        if rw is not None:          # rolled back; batches already skipped
            state, step = rw.state, rw.step
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Optional

from .watchdog import record_incident

__all__ = ["RewindBudgetExceeded", "RewindResult", "RewindGuard"]


class RewindBudgetExceeded(RuntimeError):
    """The rewind budget is spent and the loss is still diverging —
    fail loudly: this is a real bug (data, numerics, or hardware), not
    a transient to paper over."""


class RewindResult:
    """What a rewind produced: the restored ``state``, the ``step`` it
    resumes from, and the batch window that was skipped."""

    __slots__ = ("state", "step", "anomaly_step", "skipped_batches",
                 "reason")

    def __init__(self, state, step, anomaly_step, skipped_batches, reason):
        self.state = state
        self.step = int(step)
        self.anomaly_step = int(anomaly_step)
        self.skipped_batches = int(skipped_batches)
        self.reason = reason

    def __repr__(self):
        return (f"RewindResult(step={self.step}, anomaly_step="
                f"{self.anomaly_step}, skipped_batches="
                f"{self.skipped_batches}, reason={self.reason!r})")


def _metrics():
    from ..profiler import metrics
    return metrics


class RewindGuard:
    """Training-loop guard: feed it ``(step, loss)`` every step; on an
    anomaly it restores the last committed checkpoint and skips the
    offending batch window, within a bounded budget.

    ``manager`` is a :class:`~..distributed.fault_tolerance.
    CheckpointManager`; ``data`` (anything with ``state_dict``/
    ``load_state_dict`` — the DataLoader or DistributedBatchSampler) is
    advanced past the skipped window. When the manager already has the
    loader attached (``attach_data``), restore first replays the
    manifest's cursor and the guard then advances it; passing ``data``
    here is still required so the guard knows *what* to advance.
    """

    def __init__(self, manager, *, data=None, max_rewinds: int = 2,
                 spike_factor: float = 10.0, window: int = 32,
                 min_history: int = 5, skip_extra: int = 0,
                 restore_target: Any = None,
                 allow_version_skew: bool = False):
        if max_rewinds < 0:
            raise ValueError("max_rewinds must be >= 0")
        self.manager = manager
        self.data = data
        self.max_rewinds = int(max_rewinds)
        self.spike_factor = float(spike_factor)
        self.skip_extra = int(skip_extra)
        self.min_history = int(min_history)
        self.restore_target = restore_target
        self.allow_version_skew = bool(allow_version_skew)
        self.rewinds = 0
        self._history: deque = deque(maxlen=int(window))

    # -- detection ----------------------------------------------------------
    def classify(self, loss) -> Optional[str]:
        """``None`` for a healthy loss, else ``"nonfinite"``/``"spike"``."""
        try:
            val = float(loss)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(val):
            return "nonfinite"
        if len(self._history) >= self.min_history:
            ref = sorted(self._history)[len(self._history) // 2]
            if ref > 0 and val > self.spike_factor * ref:
                return "spike"
        return None

    # -- the guard ----------------------------------------------------------
    def check(self, step: int, loss) -> Optional[RewindResult]:
        """Healthy -> records the loss and returns None. Anomalous ->
        performs the rewind and returns a :class:`RewindResult` (or
        raises :class:`RewindBudgetExceeded` once the budget is spent)."""
        reason = self.classify(loss)
        if reason is None:
            self._history.append(float(loss))
            return None
        return self.rewind(step, loss=loss, reason=reason)

    def rewind(self, anomaly_step: int, *, loss=None,
               reason: str = "manual") -> RewindResult:
        """Roll back to the newest committed checkpoint and skip the
        batch window ``(restored_step, anomaly_step]`` (+ skip_extra)."""
        m = _metrics()
        if self.rewinds >= self.max_rewinds:
            record_incident("rewind_budget_exhausted",
                            step=int(anomaly_step), reason=reason,
                            rewinds=self.rewinds, budget=self.max_rewinds)
            raise RewindBudgetExceeded(
                f"loss anomaly ({reason}) at step {anomaly_step} but the "
                f"rewind budget ({self.max_rewinds}) is already spent — "
                f"the divergence is persistent; inspect the incident "
                f"buffer and the last checkpoints instead of rewinding "
                f"further")
        target = self.manager.latest_step()
        if target is None:
            record_incident("rewind_failed", step=int(anomaly_step),
                            reason=reason, error="no committed checkpoint")
            raise RewindBudgetExceeded(
                f"loss anomaly ({reason}) at step {anomaly_step} with NO "
                f"committed checkpoint to rewind to under "
                f"{self.manager.root}")
        state, restored = self.manager.restore(
            self.restore_target, step=target,
            allow_version_skew=self.allow_version_skew)
        nskip = max(0, int(anomaly_step) - int(restored)) + self.skip_extra
        if self.data is not None and nskip > 0:
            self._advance_data(nskip)
        self.rewinds += 1
        self._history.clear()
        try:
            loss_val = float(loss) if loss is not None else None
        except (TypeError, ValueError):
            loss_val = None
        record_incident(
            "anomaly_rewind", step=int(anomaly_step), reason=reason,
            restored_step=int(restored), skipped_batches=nskip,
            loss=repr(loss_val), rewinds=self.rewinds,
            budget=self.max_rewinds)
        if m.enabled():
            m.counter("rewind_total",
                      "Anomaly rewinds to the last committed checkpoint"
                      ).inc()
            m.counter("rewind_skipped_batches_total",
                      "Batches skipped past by anomaly rewinds"
                      ).inc(nskip)
        return RewindResult(state, restored, anomaly_step, nskip, reason)

    def _advance_data(self, nbatches: int):
        st = self.data.state_dict()
        gbs = int(st.get("global_batch_size", 1))
        st["offset"] = int(st.get("offset", 0)) + int(nbatches) * gbs
        self.data.load_state_dict(st)
