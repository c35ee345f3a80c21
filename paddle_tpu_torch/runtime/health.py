"""Cross-rank health monitoring: heartbeats, hang detection, exit-101
(the port of ``paddle_tpu/runtime/health.py``).

:class:`HealthMonitor` runs a daemon thread per rank on top of the
rendezvous store (``distributed/store.py``):

- **Heartbeats**: each rank publishes ``health/{job}/{restart}/hb/{rank}``
  with a monotonically increasing counter plus a payload (step, phase,
  in-flight collective). Failure detection is *timeout-based on the
  observer's clock*: a peer whose counter stops changing for
  ``heartbeat_timeout`` seconds is declared dead — no cross-host clock
  agreement needed.
- **Collective beacons**: ``distributed/collective.py`` wraps every op in
  :func:`collective_beacon`. Entering a collective stamps the local
  in-flight record (and an immediate heartbeat) — a rank that enters
  and never exits is detected two ways: by itself (the monitor thread
  notices the overdue local beacon even while the main thread is stuck)
  and by every peer (the advertised beacon ages past the deadline).
- **Conversion**: detection → structured incident + final save (via the
  callback registered with :meth:`register_final_save`) + a shared
  ``fail`` flag so the whole gang converges, then ``os._exit(101)`` —
  the relaunch exit code the elastic launcher honors without burning
  restart budget.
- **Stragglers**: ranks whose step counter trails the gang max by more
  than ``straggler_skew`` steps are flagged (gauge + incident), the
  soft-failure precursor of a hang.

:class:`HeartbeatTracker`, the observer-clock staleness rule, is shared
with the serving router, which tracks replica liveness with it.
Everything is injectable (clock, exit function) so detection logic is
unit-testable without real processes or sleeps. With no monitor
installed, the module-level hooks cost one global ``None`` check.  The
reference's ``record_fused_fallback`` has no counterpart: the port has
no runtime fallback from a kernel to its plain version.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Set

from .watchdog import (PhaseTimeout, record_incident, persist_incidents,
                       _dump_all_threads)

__all__ = ["CollectiveTimeout", "HealthMonitor", "HeartbeatTracker",
           "install", "uninstall", "get", "monitored", "current_step",
           "set_step", "collective_beacon", "RELAUNCH_EXIT_CODE"]

RELAUNCH_EXIT_CODE = 101  # distributed.fault_tolerance's contract


class CollectiveTimeout(PhaseTimeout):
    """A rank entered a collective and did not exit within the deadline
    (phase ``collective``)."""

    def __init__(self, op: str, rank: int, elapsed_s: float,
                 deadline_s: float):
        self.op = op
        self.rank = rank
        super().__init__("collective", elapsed_s, deadline_s,
                         detail=f"{op} on rank {rank}")


class HeartbeatTracker:
    """Observer-clock heartbeat staleness: a peer is declared dead when
    its published counter stops CHANGING for ``timeout_s`` seconds on
    the *observer's* clock — no cross-host clock agreement needed.

    This is the failure-detection rule :class:`HealthMonitor` applies to
    peer ranks, factored out so other observers can reuse it: the
    serving :class:`~paddle_tpu_torch.serving.router.Router` tracks
    engine replica liveness with the same machinery. The clock is
    injectable so staleness is unit-testable without sleeping.
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


class HealthMonitor:
    """Per-rank failure detector over the rendezvous store."""

    def __init__(self, store, rank: int, world_size: int, *,
                 job_id: Optional[str] = None,
                 restart: Optional[int] = None,
                 heartbeat_interval: float = 2.0,
                 heartbeat_timeout: float = 10.0,
                 collective_deadline: Optional[float] = None,
                 straggler_skew: int = 5,
                 clock: Callable[[], float] = time.monotonic,
                 final_save: Optional[Callable[[], None]] = None,
                 exit_fn: Callable[[int], None] = os._exit,
                 dump: bool = True):
        if job_id is None:
            job_id = os.environ.get("PADDLE_JOB_ID", "job")
        if restart is None:
            restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
        if collective_deadline is None:
            from ..flags import flag
            collective_deadline = float(flag("FLAGS_tpu_watchdog_collective"))
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.prefix = f"health/{job_id}/{restart}"
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.collective_deadline = (float(collective_deadline)
                                    if collective_deadline
                                    and collective_deadline > 0 else None)
        self.straggler_skew = int(straggler_skew)
        self._clock = clock
        self._final_save = final_save
        self._exit_fn = exit_fn
        self._dump = dump

        self._beat_n = 0
        self._step: Optional[int] = None
        self._phase: Optional[str] = None
        # in-flight collective: {"op", "seq", "since" (wall), "entered"
        # (local clock)} — written by the main thread, read by the
        # monitor thread; replaced atomically, never mutated
        self._coll: Optional[Dict[str, Any]] = None
        self._coll_seq = 0
        # peer staleness: the shared observer-clock timeout detector
        self._tracker = HeartbeatTracker(self.heartbeat_timeout,
                                         clock=clock)
        self.dead: Set[int] = set()
        self.stragglers: Set[int] = set()
        self.failed: Optional[str] = None  # reason, once converted
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- publishing ----------------------------------------------------------

    def _hb_key(self, rank: int) -> str:
        return f"{self.prefix}/hb/{rank}"

    def beat(self):
        """Publish this rank's heartbeat. Best-effort: a flaky store
        drops a beat, and a dropped beat *is* the failure signal the
        peers act on — raising here would add a second, noisier one."""
        self._beat_n += 1
        coll = self._coll
        payload = {"n": self._beat_n, "step": self._step,
                   "phase": self._phase, "t": time.time(),
                   "pid": os.getpid(),
                   "coll": ({"op": coll["op"], "seq": coll["seq"],
                             "since": coll["since"]} if coll else None)}
        try:
            self.store.set(self._hb_key(self.rank), pickle.dumps(payload))
        except Exception:  # noqa: BLE001
            pass

    def set_step(self, step: int):
        self._step = int(step)

    def set_phase(self, phase: Optional[str]):
        self._phase = phase

    @contextmanager
    def collective(self, op_name: str):
        """Entry/exit beacon around one collective op. Local state is
        stamped before anything that can block (the store publish, the
        chaos hook, the op itself) so self-detection works even when
        the very first blocking thing is the hang."""
        self._coll_seq += 1
        self._coll = {"op": op_name, "seq": self._coll_seq,
                      "since": time.time(), "entered": self._clock()}
        self.beat()  # advertise entry promptly (periodic beats carry it on)
        try:
            yield
        finally:
            self._coll = None
            self.beat()

    # -- detection -----------------------------------------------------------

    def check(self) -> List[Dict[str, Any]]:
        """One detector pass; returns the incidents it raised. Called
        from the monitor thread, and directly by tests with an injected
        clock."""
        now = self._clock()
        found: List[Dict[str, Any]] = []

        # gang-wide fail flag: a peer already converted — follow it
        try:
            raw = self.store.get(f"{self.prefix}/fail")
        except Exception:
            raw = None
        if raw:
            try:
                why = pickle.loads(raw)
            except Exception:
                why = {"reason": "peer failure", "rank": -1}
            self._convert(f"peer rank {why.get('rank')} reported: "
                          f"{why.get('reason')}", propagate=False)
            return found

        # self: overdue in-flight collective (main thread may be stuck)
        coll = self._coll
        if (coll is not None and self.collective_deadline is not None
                and now - coll["entered"] > self.collective_deadline):
            exc = CollectiveTimeout(coll["op"], self.rank,
                                    now - coll["entered"],
                                    self.collective_deadline)
            found.append(record_incident(
                "collective_timeout", op=coll["op"], peer=self.rank,
                step=self._step, elapsed_s=round(exc.elapsed_s, 3),
                deadline_s=exc.deadline_s))
            self._metric("collective_timeout_total", op=coll["op"])
            if self._dump:
                _dump_all_threads(str(exc))
            self._convert(str(exc))
            return found

        steps: Dict[int, int] = {}
        if self._step is not None:
            steps[self.rank] = self._step
        for peer in range(self.world_size):
            if peer == self.rank:
                continue
            try:
                raw = self.store.get(self._hb_key(peer))
            except Exception:
                raw = None
            if raw is None:
                continue  # not started yet; dead-before-first-beat is
                #           the launcher/rendezvous layer's problem
            try:
                payload = pickle.loads(raw)
            except Exception:
                continue
            silent = self._tracker.observe(peer, payload["n"])
            if (silent > self.heartbeat_timeout
                    and peer not in self.dead):
                self.dead.add(peer)
                found.append(record_incident(
                    "rank_dead", peer=peer, step=payload.get("step"),
                    peer_pid=payload.get("pid"),
                    silent_s=round(silent, 3),
                    timeout_s=self.heartbeat_timeout))
                self._metric("health_rank_dead_total", peer=str(peer))
                self._convert(f"rank {peer} heartbeat silent "
                              f"{silent:.1f}s "
                              f"(> {self.heartbeat_timeout:.1f}s)")
                return found
            if payload.get("step") is not None:
                steps[peer] = payload["step"]
            pcoll = payload.get("coll")
            if (pcoll is not None and self.collective_deadline is not None
                    and time.time() - pcoll["since"]
                    > self.collective_deadline):
                exc = CollectiveTimeout(pcoll["op"], peer,
                                        time.time() - pcoll["since"],
                                        self.collective_deadline)
                found.append(record_incident(
                    "collective_timeout", op=pcoll["op"], peer=peer,
                    step=payload.get("step"),
                    elapsed_s=round(exc.elapsed_s, 3),
                    deadline_s=exc.deadline_s))
                self._metric("collective_timeout_total", op=pcoll["op"])
                self._convert(str(exc))
                return found

        # stragglers: soft flag only — skew is a precursor, not a failure
        if len(steps) >= 2:
            top = max(steps.values())
            for peer, s in steps.items():
                if top - s > self.straggler_skew:
                    if peer not in self.stragglers:
                        self.stragglers.add(peer)
                        found.append(record_incident(
                            "straggler", peer=peer, step=s, gang_max=top,
                            skew=top - s))
                        self._metric("health_straggler_total",
                                     peer=str(peer))
                else:
                    self.stragglers.discard(peer)
            self._gauge("health_straggler_ranks", len(self.stragglers))
        return found

    def _metric(self, name: str, **labels):
        from ..profiler import metrics
        if metrics.enabled():
            metrics.counter(name, "Runtime health detector events",
                            **labels).inc()

    def _gauge(self, name: str, value):
        from ..profiler import metrics
        if metrics.enabled():
            metrics.gauge(name, "Runtime health detector state").set(value)

    # -- conversion: detection -> final save -> exit 101 ---------------------

    def register_final_save(self, fn: Callable[[], None]):
        """Register the final-save callback (typically: write a
        checkpoint from the last completed-step state snapshot). It runs
        on the MONITOR thread — the main thread may be hung — so it must
        only touch state handed over at step boundaries."""
        self._final_save = fn

    def _convert(self, reason: str, propagate: bool = True):
        with self._lock:
            if self.failed is not None:
                return
            self.failed = reason
        record_incident("health_exit", reason=reason[-500:],
                        step=self._step, exit_code=RELAUNCH_EXIT_CODE)
        if propagate:
            # gang-wide flag: peers convert on their next check instead
            # of waiting out their own deadlines
            try:
                self.store.set(f"{self.prefix}/fail", pickle.dumps(
                    {"reason": reason[-500:], "rank": self.rank,
                     "t": time.time()}))
            except Exception:  # noqa: BLE001
                pass
        if self._final_save is not None:
            try:
                self._final_save()
            # the save is best-effort by design: the previous committed
            # checkpoint stays valid (crash-consistent commit)
            except Exception as e:
                record_incident("final_save_failed", error=str(e)[-500:])
        # exit_fn defaults to os._exit, which skips atexit — flush the
        # incident buffer now or the post-mortem sidecar never lands
        try:
            persist_incidents()
        except OSError as e:
            record_incident("incident_persist_failed", error=str(e)[-500:])
        self._exit_fn(RELAUNCH_EXIT_CODE)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self.beat()  # one synchronous beat: peers see us immediately

        def _loop():
            while not self._stop.wait(self.heartbeat_interval):
                try:
                    self.beat()
                    self.check()
                # the monitor is the last line of defense — it must
                # outlive any store hiccup or metrics error
                except Exception:  # noqa: BLE001
                    pass

        self._thread = threading.Thread(target=_loop, name="ptq-health",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"rank": self.rank, "world_size": self.world_size,
                "pid": os.getpid(),
                "beats": self._beat_n, "step": self._step,
                "dead": sorted(self.dead),
                "stragglers": sorted(self.stragglers),
                "failed": self.failed}

    def summary_lines(self) -> List[str]:
        s = self.stats()
        lines = [f"rank {s['rank']}/{s['world_size']}: "
                 f"{s['beats']} heartbeats, step {s['step']}, "
                 f"{len(s['dead'])} dead, "
                 f"{len(s['stragglers'])} straggler(s)"]
        if s["dead"]:
            lines.append(f"dead ranks: {s['dead']}")
        if s["stragglers"]:
            lines.append(f"stragglers: {s['stragglers']}")
        if s["failed"]:
            lines.append(f"converted to exit-{RELAUNCH_EXIT_CODE}: "
                         f"{s['failed']}")
        return lines


# -- module-global install (zero-cost hooks when absent) ---------------------

_MONITOR: Optional[HealthMonitor] = None


def install(monitor: HealthMonitor) -> HealthMonitor:
    global _MONITOR
    _MONITOR = monitor
    return monitor


def uninstall():
    global _MONITOR
    _MONITOR = None


def get() -> Optional[HealthMonitor]:
    return _MONITOR


def monitored() -> bool:
    return _MONITOR is not None


def current_step() -> Optional[int]:
    m = _MONITOR
    return m._step if m is not None else None


def set_step(step: int):
    m = _MONITOR
    if m is not None:
        m.set_step(step)


@contextmanager
def collective_beacon(op_name: str):
    """Hook for distributed/collective.py — one ``None`` check when no
    monitor is installed."""
    m = _MONITOR
    if m is None:
        yield
        return
    with m.collective(op_name):
        yield
