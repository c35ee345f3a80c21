"""Liveness by heartbeat: the port's copy of ``HeartbeatTracker`` from
``paddle_tpu/runtime/health.py``, which the serving router uses to
declare an engine replica dead.

Not ported yet: ``HealthMonitor`` (the cross-rank detector over a
store, with collective beacons and the exit-101 relaunch), which comes
with the train runtime (ROADMAP A3).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

__all__ = ["HeartbeatTracker"]


class HeartbeatTracker:
    """Observer-clock heartbeat staleness: a peer is declared dead when
    its published counter stops CHANGING for ``timeout_s`` seconds on
    the *observer's* clock — no cross-host clock agreement needed.

    The serving :class:`~paddle_tpu_torch.serving.router.Router` tracks
    engine replica liveness with it.  The clock is injectable so
    staleness is unit-testable without sleeping.
    """

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = float(timeout_s)
        self._clock = clock
        # name -> [last counter value, local time it last changed]
        self._seen: Dict[Any, List[float]] = {}

    def observe(self, name, counter) -> float:
        """Record the latest counter for ``name``; returns how long (s)
        the counter has been unchanged (0.0 when it just advanced)."""
        now = self._clock()
        seen = self._seen.get(name)
        if seen is None or seen[0] != counter:
            self._seen[name] = [counter, now]
            return 0.0
        return now - seen[1]

    def silent_for(self, name) -> float:
        """Seconds since ``name``'s counter last changed (0.0 if never
        observed)."""
        seen = self._seen.get(name)
        return 0.0 if seen is None else self._clock() - seen[1]

    def is_stale(self, name) -> bool:
        seen = self._seen.get(name)
        return (seen is not None
                and self._clock() - seen[1] > self.timeout_s)

    def stale(self) -> List:
        return [n for n in self._seen if self.is_stale(n)]

    def forget(self, name) -> None:
        self._seen.pop(name, None)
