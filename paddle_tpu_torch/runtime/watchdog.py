"""Phase watchdogs and the deadline executor: the port's copy of
``paddle_tpu/runtime/watchdog.py`` as far as serving needs it.

``Watchdog``
    Named phases (``serve.step`` here) with per-phase deadlines, from
    the constructor or from the ``FLAGS_tpu_watchdog_*`` flags
    (``paddle_tpu_torch.flags``).  A synchronous state
    machine — ``begin``/``end``/``poll`` — with an injectable clock, so
    expiry is testable without real sleeps, plus an optional ticker
    thread.  On expiry: an all-thread stack dump,
    ``watchdog_expired_total{phase=}``, an incident record and a typed
    :class:`PhaseTimeout`.

``run_with_deadline``
    Daemon-thread executor: run ``fn`` with a wall-clock budget, raise
    :class:`PhaseTimeout` if it does not land (the router bounds each
    replica's step with it).

Incident records accumulate in a bounded in-memory buffer
(``incidents()``); the first record arms an atexit hook that writes the
buffer to a JSONL sidecar (``persist_incidents``,
``incident_sidecar_path``), and the exit-101 paths, which leave through
``os._exit``, persist it themselves.  ``phase`` is the framework's
flag-gated phase hook (``collective``, ``ckpt.commit``, ``serve.step``).

``init_with_retries``
    Device init with retries: each attempt on a daemon thread, a failed
    one retried with exponential backoff inside a window, a hung one
    not retried (``bench.main`` and ``chip_smoke.py`` probe the card
    with it).
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from .. import flags as _flags

__all__ = ["PhaseTimeout", "Watchdog", "run_with_deadline",
           "record_incident", "incidents", "clear_incidents",
           "last_incident", "persist_incidents", "incident_sidecar_path",
           "INCIDENT_SCHEMA", "PHASES", "phase", "global_watchdog",
           "watchdog_enabled", "init_with_retries", "probe_device"]

# canonical phases and the flag holding each deadline (seconds; <= 0
# disables that phase's deadline)
PHASES = {
    "collective": "FLAGS_tpu_watchdog_collective",
    "ckpt.commit": "FLAGS_tpu_watchdog_ckpt_commit",
    "serve.step": "FLAGS_tpu_watchdog_serve_step",
}


def watchdog_enabled() -> bool:
    """``FLAGS_tpu_watchdog`` (default off): the framework's phase sites
    arm the global watchdog only when it is set."""
    return bool(_flags.flag("FLAGS_tpu_watchdog"))


class PhaseTimeout(TimeoutError):
    """A watched phase exceeded its deadline (the job is hung, not
    crashed — the caller decides whether to recover, save or exit)."""

    def __init__(self, phase: str, elapsed_s: float, deadline_s: float,
                 detail: str = ""):
        self.phase = phase
        self.elapsed_s = float(elapsed_s)
        self.deadline_s = float(deadline_s)
        self.detail = detail
        msg = (f"phase {phase!r} exceeded its {deadline_s:.1f}s deadline "
               f"(elapsed {elapsed_s:.1f}s)")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


# -- incident records --------------------------------------------------------

_INCIDENTS: List[Dict[str, Any]] = []
_INCIDENTS_MAX = 64
_INCIDENTS_LOCK = threading.Lock()
_PERSIST_REGISTERED = False

# the sidecar's schema: the reference's, so tools/trace_report.py
# --incidents reads either package's files
INCIDENT_SCHEMA = "paddle_tpu.incidents.v1"


def record_incident(kind: str, **fields) -> Dict[str, Any]:
    """Append a structured incident ``{kind, time, rank, pid,
    **fields}`` to the bounded in-memory buffer and return it.  The
    first record arms an atexit hook that persists the buffer to its
    JSONL sidecar (:func:`persist_incidents`)."""
    global _PERSIST_REGISTERED
    rec = {"kind": kind, "time": time.time(),
           "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
           "pid": os.getpid()}
    rec.update(fields)
    with _INCIDENTS_LOCK:
        _INCIDENTS.append(rec)
        del _INCIDENTS[:-_INCIDENTS_MAX]
        if not _PERSIST_REGISTERED:
            _PERSIST_REGISTERED = True
            atexit.register(_persist_at_exit)
    from ..profiler import metrics
    if metrics.enabled():
        metrics.counter("health_incidents_total",
                        "Structured runtime-health incidents",
                        kind=kind).inc()
    return rec


def incidents() -> List[Dict[str, Any]]:
    with _INCIDENTS_LOCK:
        return list(_INCIDENTS)


def last_incident() -> Optional[Dict[str, Any]]:
    with _INCIDENTS_LOCK:
        return _INCIDENTS[-1] if _INCIDENTS else None


def clear_incidents():
    with _INCIDENTS_LOCK:
        del _INCIDENTS[:]


def incident_sidecar_path() -> str:
    """Where :func:`persist_incidents` writes by default:
    ``$PADDLE_TPU_INCIDENTS_OUT`` when set, else
    ``incidents_rank<N>.jsonl`` under ``$PADDLE_TPU_INCIDENT_DIR``
    (default: the current directory)."""
    explicit = os.environ.get("PADDLE_TPU_INCIDENTS_OUT")
    if explicit:
        return explicit
    base = os.environ.get("PADDLE_TPU_INCIDENT_DIR", ".")
    try:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        rank = 0
    return os.path.join(base, f"incidents_rank{rank}.jsonl")


def persist_incidents(path: Optional[str] = None) -> Optional[str]:
    """Flush the incident buffer to a JSONL sidecar (a header line with
    the schema, rank and pid, then one incident a line; tmp file +
    rename).  A no-op when the buffer is empty.  Runs at normal exit
    once an incident exists; the exit-101 paths call it themselves,
    because ``os._exit`` skips atexit."""
    recs = incidents()
    if not recs:
        return None
    path = path or incident_sidecar_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    header = {"schema": INCIDENT_SCHEMA, "pid": os.getpid(),
              "rank": recs[-1].get("rank", 0), "wall_time": time.time(),
              "count": len(recs)}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
    os.replace(tmp, path)
    return path


def _persist_at_exit():
    try:
        persist_incidents()
    except OSError as exc:  # a read-only directory: the sidecar is lost
        sys.stderr.write(f"watchdog: incident persist failed: {exc}\n")


def _dump_all_threads(reason: str):
    """faulthandler all-thread dump — where exactly is everyone stuck."""
    try:
        sys.stderr.write(f"watchdog: {reason}; all-thread stack dump:\n")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
    # diagnostics must never mask the timeout being reported (stderr may
    # be a closed pipe under a dying launcher)
    except (OSError, ValueError):
        pass


def _expired_metric(phase: str):
    from ..profiler import metrics
    if metrics.enabled():
        metrics.counter("watchdog_expired_total",
                        "Phase-deadline expiries", phase=phase).inc()


class Watchdog:
    """Deadline bookkeeping for named phases.

    Synchronous core: ``begin(phase)`` arms a deadline, ``end(phase)``
    disarms and returns the elapsed time, ``poll()`` expires overdue
    phases (dump + incident + ``on_expire`` callback, then raises
    :class:`PhaseTimeout` unless ``raise_on_expire=False``).  ``clock``
    is injectable so tests drive expiry without sleeping.

    A ticker thread (``start_ticker``) polls on real time, so a hung
    main thread still produces the stack dump and the incident record
    even though nothing can raise into it.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 deadlines: Optional[Dict[str, float]] = None,
                 on_expire: Optional[Callable[[PhaseTimeout], None]] = None,
                 dump: bool = True):
        self._clock = clock
        self._deadlines = dict(deadlines or {})
        self._on_expire = on_expire
        self._dump = dump
        self._active: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.expired: List[PhaseTimeout] = []

    def deadline_for(self, phase: str) -> Optional[float]:
        """Explicit per-instance deadline, else the phase's flag, else
        None (unwatched)."""
        if phase in self._deadlines:
            d = self._deadlines[phase]
            return float(d) if d and d > 0 else None
        flag_name = PHASES.get(phase)
        if flag_name is None:
            return None
        d = float(_flags.flag(flag_name))
        return d if d > 0 else None

    def begin(self, phase: str, deadline_s: Optional[float] = None):
        d = deadline_s if deadline_s is not None else self.deadline_for(phase)
        with self._lock:
            self._active[phase] = {"start": self._clock(),
                                   "deadline": d, "expired": False}

    def end(self, phase: str) -> float:
        with self._lock:
            info = self._active.pop(phase, None)
        if info is None:
            return 0.0
        return self._clock() - info["start"]

    def active_phases(self) -> List[str]:
        with self._lock:
            return list(self._active)

    @contextmanager
    def phase(self, name: str, deadline_s: Optional[float] = None):
        """Scope a phase; expiry enforcement comes from ``poll()`` (same
        thread between steps, or the ticker thread during a hang)."""
        self.begin(name, deadline_s)
        try:
            yield self
        finally:
            self.end(name)

    def poll(self, raise_on_expire: bool = True) -> List[PhaseTimeout]:
        """Expire every active phase past its deadline.  Each phase
        expires at most once (the ticker would otherwise dump stacks
        every tick while the hang persists)."""
        now = self._clock()
        newly: List[PhaseTimeout] = []
        with self._lock:
            for phase, info in self._active.items():
                d = info["deadline"]
                if d is None or info["expired"]:
                    continue
                elapsed = now - info["start"]
                if elapsed > d:
                    info["expired"] = True
                    newly.append(PhaseTimeout(phase, elapsed, d))
        for exc in newly:
            self.expired.append(exc)
            if self._dump:
                _dump_all_threads(str(exc))
            _expired_metric(exc.phase)
            record_incident("watchdog_expired", phase=exc.phase,
                            elapsed_s=round(exc.elapsed_s, 3),
                            deadline_s=exc.deadline_s)
            if self._on_expire is not None:
                try:
                    self._on_expire(exc)
                # a user callback must not turn a reported hang into a
                # different failure
                except Exception:  # noqa: BLE001
                    pass
        if newly and raise_on_expire:
            raise newly[0]
        return newly

    # -- ticker ----------------------------------------------------------

    def start_ticker(self, interval_s: float = 1.0):
        """Poll on a daemon thread so a hung main thread still produces
        the dump and the incident (it cannot be *raised* into)."""
        if self._ticker is not None and self._ticker.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll(raise_on_expire=False)
                # the ticker must survive any poll-side error — it is
                # the last line of hang diagnostics
                except Exception:  # noqa: BLE001
                    pass

        self._ticker = threading.Thread(
            target=_loop, name="ptq-watchdog", daemon=True)
        self._ticker.start()

    def stop_ticker(self):
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
            self._ticker = None


# -- process-global watchdog (flag-gated wiring for framework sites) ---------

_GLOBAL: Optional[Watchdog] = None
_GLOBAL_LOCK = threading.Lock()


def global_watchdog() -> Watchdog:
    """Lazily created shared instance with the 1 s ticker armed, used by
    the framework's phase sites when ``FLAGS_tpu_watchdog`` is set."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Watchdog()
            _GLOBAL.start_ticker(interval_s=1.0)
        return _GLOBAL


@contextmanager
def phase(name: str, deadline_s: Optional[float] = None):
    """Framework phase hook: a no-op (one flag lookup) unless
    ``FLAGS_tpu_watchdog`` is on."""
    if not watchdog_enabled():
        yield
        return
    with global_watchdog().phase(name, deadline_s):
        yield


def run_with_deadline(fn: Callable[[], Any], window_s: float, *,
                      phase: str = "deadline", dump: bool = True):
    """Run ``fn()`` on a daemon thread with a wall-clock budget.

    Returns ``fn``'s value; re-raises its exception.  If the budget
    expires first: all-thread stack dump + ``watchdog_expired_total``
    + incident record, then :class:`PhaseTimeout`.  The worker thread is
    abandoned (daemon) — by construction it is hung on something
    uninterruptible, which is exactly why the caller needs its control
    flow back.  It keeps running to its end and may still touch what
    ``fn`` closes over, so the caller drops references only.
    """
    box: Dict[str, Any] = {}
    done = threading.Event()

    def _work():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            box["exc"] = e
        finally:
            done.set()

    th = threading.Thread(target=_work, name=f"ptq-deadline-{phase}",
                          daemon=True)
    th.start()
    if not done.wait(window_s):
        exc = PhaseTimeout(phase, window_s, window_s,
                           detail="still running at deadline")
        if dump:
            _dump_all_threads(str(exc))
        _expired_metric(phase)
        record_incident("watchdog_expired", phase=phase,
                        elapsed_s=window_s, deadline_s=window_s,
                        detail="run_with_deadline")
        raise exc
    if "exc" in box:
        raise box["exc"]
    return box["value"]


def init_with_retries(probe_fn, window_s: float = 240.0,
                      base_delay: float = 5.0, factor: float = 2.0,
                      max_delay: float = 60.0, log=None,
                      sleep=time.sleep, clock=time.monotonic,
                      phase: str = "device_init"):
    """Retry a failing device init with exponential backoff until the
    ``window_s`` budget is spent.

    An init fails two ways: ``probe_fn`` raises (often transient, while
    another job releases the card: retried), or it never returns.  Each
    attempt runs on its own daemon thread, so a hang costs at most the
    rest of the window; a hung attempt is not retried, because the
    CUDA runtime's init lock would hold every later attempt behind it (a
    ``watchdog_expired`` incident).  Returns ``(ok, attempts,
    last_error)``; a window spent on failures records ``init_failed``.
    ``sleep`` and ``clock`` are injectable."""
    deadline = clock() + window_s
    delay = base_delay
    attempts = 0
    last_err = "no attempt made"
    while clock() < deadline:
        attempts += 1
        box: Dict[str, Any] = {}
        done = threading.Event()

        def _attempt():
            try:
                probe_fn()
                box["ok"] = True
            except Exception as e:  # noqa: BLE001 — classified below
                box["err"] = str(e) or repr(e)
            finally:
                done.set()

        th = threading.Thread(target=_attempt, name=f"ptq-{phase}",
                              daemon=True)
        th.start()
        finished = done.wait(max(0.0, deadline - clock()))
        if box.get("ok"):
            return True, attempts, None
        if not finished:
            _expired_metric(phase)
            record_incident("watchdog_expired", phase=phase,
                            elapsed_s=window_s, deadline_s=window_s,
                            detail=f"init attempt {attempts} hung")
            return False, attempts, (
                f"attempt {attempts} hung past the {window_s:.0f}s window")
        last_err = box.get("err", "unknown init failure")
        pause = min(delay, max(0.0, deadline - clock()))
        if pause <= 0:
            break
        if log:
            log(f"device init attempt {attempts} failed ({last_err}); "
                f"retrying in {pause:.1f}s")
        sleep(pause)
        delay = min(delay * factor, max_delay)
    record_incident("init_failed", phase=phase, attempts=attempts,
                    window_s=window_s, error=str(last_err)[-500:])
    return False, attempts, last_err


def probe_device(device=None) -> None:
    """A real init of the card: ``torch.cuda.init()``, one small launch
    and a synchronize (raises when there is no card, or it refuses)."""
    import torch
    from ..testing.chaos import chaos_point
    chaos_point("device.init")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    torch.cuda.init()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    x = torch.ones(1024, device=dev)
    if float((x * 2).sum()) != 2048.0:
        raise RuntimeError(f"probe launch on {dev} computed a wrong sum")
    torch.cuda.synchronize(dev)
