"""Runtime health for the port (the port of ``paddle_tpu/runtime``): the
phase watchdog, the deadline executor and device init with retries
(``watchdog``), liveness by heartbeat and collective beacons
(``health``), and anomaly rewind to the last committed checkpoint
(``rewind``)."""
from __future__ import annotations

from typing import List

from . import health, rewind, watchdog  # noqa: F401
from .health import (CollectiveTimeout, HealthMonitor,  # noqa: F401
                     HeartbeatTracker, collective_beacon)
from .rewind import (RewindBudgetExceeded, RewindGuard,  # noqa: F401
                     RewindResult)
from .watchdog import (PhaseTimeout, Watchdog, clear_incidents,  # noqa: F401
                       incident_sidecar_path, incidents, init_with_retries,
                       last_incident, persist_incidents, record_incident,
                       run_with_deadline)

__all__ = ["watchdog", "health", "rewind", "PhaseTimeout", "Watchdog",
           "run_with_deadline", "init_with_retries", "incidents",
           "last_incident", "record_incident", "clear_incidents",
           "persist_incidents", "incident_sidecar_path",
           "CollectiveTimeout", "HealthMonitor", "HeartbeatTracker",
           "collective_beacon", "RewindBudgetExceeded", "RewindResult",
           "RewindGuard", "summary_lines"]


def summary_lines() -> List[str]:
    """The "Health" section of ``Profiler.summary_table()``: the
    watchdog flag, the monitor (when one is installed) and the tail of
    the incident buffer."""
    from ..flags import flag
    lines: List[str] = ["Health"]
    mon = health.get()
    if mon is None:
        state = "on" if flag("FLAGS_tpu_watchdog") else "off"
        lines.append(f"  monitor: not installed (FLAGS_tpu_watchdog "
                     f"{state})")
    else:
        lines.extend("  " + ln for ln in mon.summary_lines())
    recs = incidents()
    if not recs:
        lines.append("  incidents: none")
        return lines
    lines.append(f"  incidents: {len(recs)} (last {min(len(recs), 5)}):")
    for rec in recs[-5:]:
        extra = {k: v for k, v in rec.items()
                 if k not in ("kind", "time", "rank")}
        detail = ", ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        lines.append(f"    {rec['kind']} (rank {rec['rank']}"
                     + (f": {detail}" if detail else "") + ")")
    return lines
