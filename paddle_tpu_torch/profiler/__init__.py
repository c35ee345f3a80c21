"""Observability of the port (the port of ``paddle_tpu/profiler``).

The ``Profiler`` with its step scheduler, host spans (``RecordEvent``,
``_record_span``) and Chrome-trace export; the device trace is a
``torch.profiler.profile`` over the CPU and CUDA activities, opened and
closed on the scheduler's RECORD edges.  Beside it:

  metrics.py          — Counter/Gauge/Histogram registry (FLAGS_tpu_metrics)
  compile_tracker.py  — the kernels' nvcc builds and cache hits
  xmem.py             — memory and aten FLOPs of captured calls, the kernels'
                        shared memory, long-lived reservations
                        (FLAGS_tpu_xmem)
  numerics.py         — NaN/Inf watchdog + first-bad-op localization
                        (FLAGS_tpu_check_nan_inf)
  trace.py            — the structured flight recorder (FLAGS_tpu_trace)
  exporter.py         — the live HTTP endpoint (FLAGS_tpu_metrics_port)
  ledger.py           — the perf ledger: schema, regression / staleness
                        gate, report and CLI (stdlib only; not imported
                        here, so ``python -m`` runs it as ``__main__``)
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from enum import Enum
from typing import Callable, Optional

from . import compile_tracker, exporter, metrics, numerics, trace, xmem

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "make_scheduler",
           "RecordEvent", "export_chrome_tracing", "benchmark", "metrics",
           "compile_tracker", "xmem", "numerics", "trace", "exporter"]

# every live Profiler: RecordEvent feeds each one's own span stats
_ACTIVE_PROFILERS: list = []


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


def make_scheduler(closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """The step-indexed state machine: ``skip_first`` steps closed, then
    periods of ``closed`` + ``ready`` + ``record`` steps (the last of
    each RECORD_AND_RETURN), ``repeat`` times (0: for ever)."""
    if closed < 0 or ready < 0 or skip_first < 0:
        raise ValueError(
            f"make_scheduler: closed/ready/skip_first must be >= 0, got "
            f"closed={closed}, ready={ready}, skip_first={skip_first}")
    if record < 1:
        raise ValueError(
            f"make_scheduler: record must be >= 1 (a period that never "
            f"records profiles nothing), got record={record}")
    if repeat < 0:
        raise ValueError(
            f"make_scheduler: repeat must be >= 0 (0 = repeat forever), "
            f"got repeat={repeat}")
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` handler that writes the profiler's trace as
    a Chrome trace_event JSON file under ``dir_name``."""

    def handler(prof):
        prof._log_dir = dir_name
        name = worker_name or f"host_{os.getpid()}"
        prof.export(os.path.join(dir_name, f"{name}.pt.trace.json"))
    return handler


class RecordEvent:
    """A host span: a ``torch.profiler.record_function`` range in the
    device trace, and an "X" event in the buffer of every recording
    Profiler."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ctx = None
        self._t0 = None

    def begin(self):
        import torch
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        t1 = time.perf_counter()
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
        if self._t0 is not None and _ACTIVE_PROFILERS:
            dt = t1 - self._t0
            event = None
            for p in _ACTIVE_PROFILERS:
                stats = p._span_stats
                calls, total, mx = stats.get(self.name, (0, 0.0, 0.0))
                stats[self.name] = (calls + 1, total + dt, max(mx, dt))
                if p._state in _RECORDING \
                        and len(p._trace_events) < p._trace_buffer_cap:
                    if event is None:
                        # complete ("X") event; ts and dur in microseconds
                        event = {"name": self.name, "ph": "X",
                                 "cat": "host",
                                 "ts": self._t0 * 1e6, "dur": dt * 1e6,
                                 "pid": os.getpid(),
                                 "tid": threading.get_ident()}
                    p._trace_events.append(event)
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _record_span(name: str):
    """RecordEvent when a Profiler is live, else a no-op context: what
    the hot paths (collectives, the data loader) pay un-profiled is one
    list truthiness check."""
    if _ACTIVE_PROFILERS:
        return RecordEvent(name)
    return contextlib.nullcontext()


def _metadata_events(events: list) -> list:
    """Chrome "M" events naming every pid/tid in ``events``: the host
    process is "host <pid>", the flight recorder's ranks "rank <N>", the
    card's streams "cuda"."""
    host_pid = os.getpid()
    pids, tids = [], []
    for e in events:
        pid, tid = e.get("pid"), e.get("tid")
        if pid is not None and pid not in pids:
            pids.append(pid)
        if pid is not None and tid is not None and (pid, tid) not in tids:
            tids.append((pid, tid))
    meta = []
    for pid in pids:
        name = (f"host {pid}" if pid == host_pid
                else pid if isinstance(pid, str) else f"rank {pid}")
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": name}})
    for pid, tid in tids:
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"thread {tid}"}})
    return meta


def _device_events(prof, t_origin_us: float) -> list:
    """The CUDA kernels and copies of a ``torch.profiler`` run as "X"
    events on the host's perf_counter clock (the profiler's own times
    start at its first event, which ``t_origin_us`` stands for)."""
    out = []
    try:
        evs = prof.events()
    except (AssertionError, RuntimeError):
        return out
    for e in evs:
        if getattr(e, "device_type", None) is None \
                or "CUDA" not in str(e.device_type):
            continue
        out.append({"name": e.name, "ph": "X", "cat": "kernel",
                    "ts": t_origin_us + e.time_range.start,
                    "dur": e.time_range.end - e.time_range.start,
                    "pid": "cuda", "tid": int(getattr(e, "device_index",
                                                      0) or 0)})
    return out


class Profiler:
    """Step-scheduled profiling: host spans always (their stats feed
    ``summary_table``), and in the RECORD states a device trace by
    ``torch.profiler`` and host events for ``export``.

    ``scheduler`` is a ``make_scheduler`` function or a ``(lo, hi)``
    pair (record steps lo .. hi - 1, once)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self._scheduler = scheduler if callable(scheduler) else None
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0,
                                             record=hi - lo, repeat=1)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._log_dir = os.environ.get("PADDLE_TPU_PROFILE_DIR",
                                       "paddle_tpu_profile")
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._torch_prof = None
        self._t_open_us = 0.0
        self._device_events: list = []
        self._step_times = []
        self._span_stats: dict = {}
        self._trace_events: list = []
        self._trace_buffer_cap = int(os.environ.get(
            "PADDLE_TPU_TRACE_BUFFER_CAP", "1000000"))
        self._last = None

    # -- the device trace -----------------------------------------------------
    def _open_trace(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._torch_prof = torch.profiler.profile(
            activities=acts, record_shapes=self._record_shapes,
            profile_memory=self._profile_memory)
        self._torch_prof.__enter__()
        self._t_open_us = time.perf_counter() * 1e6

    def _close_trace(self):
        prof, self._torch_prof = self._torch_prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        self._device_events.extend(_device_events(prof, self._t_open_us))
        self.torch_profile = prof

    def start(self):
        self._state = self._scheduler(self._step) if self._scheduler \
            else ProfilerState.RECORD
        if self._state in _RECORDING and not self._timer_only:
            self._open_trace()
        self._span_stats.clear()
        self._trace_events.clear()
        self._device_events.clear()
        if self not in _ACTIVE_PROFILERS:
            _ACTIVE_PROFILERS.append(self)
        self._last = time.perf_counter()

    def stop(self):
        self._close_trace()
        if self in _ACTIVE_PROFILERS:
            _ACTIVE_PROFILERS.remove(self)
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._step_times.append(now - self._last)
        self._last = now
        self._step += 1
        if self._scheduler is None:
            return
        new_state = self._scheduler(self._step)
        if new_state != self._state:
            recording = self._state in _RECORDING
            will_record = new_state in _RECORDING
            if will_record and self._torch_prof is None \
                    and not self._timer_only:
                self._open_trace()
            if recording and not will_record:
                self._close_trace()
            self._state = new_state

    def export(self, path: Optional[str] = None):
        """Write the host spans, the device trace's kernels and (with
        FLAGS_tpu_trace on) the flight recorder's events as one Chrome
        trace_event file (``{"traceEvents": [...]}``), with
        process/thread name events for every pid/tid.  Returns the
        path."""
        if path is None:
            path = os.path.join(self._log_dir,
                                f"host_{os.getpid()}.pt.trace.json")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events = list(self._trace_events) + list(self._device_events)
        if trace.enabled():
            events.extend(trace.chrome_events())
        payload = {
            "traceEvents": _metadata_events(events) + events,
            "displayTimeUnit": "ms",
            "metadata": {"producer": "paddle_tpu_torch.profiler",
                         "steps": self._step},
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return path

    def step_info(self, unit=None):
        if not self._step_times:
            return ""
        import numpy as np
        units = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}
        u = unit if unit in units else "ms"
        arr = np.asarray(self._step_times[-100:])
        return (f"avg step: {arr.mean() * units[u]:.2f} {u}, "
                f"ips: {1.0 / max(arr.mean(), 1e-9):.2f} steps/s")

    def _compilation_section(self) -> list:
        """The "Compilation" section: the kernels' nvcc builds, the
        libraries found built and ``to_static``'s captures (the
        reference's jaxpr traces) and retraces."""
        st = compile_tracker.stats()
        lines = ["Compilation",
                 f"  kernel builds (nvcc): {st['compile_count']}  "
                 f"(cumulative {st['compile_seconds']:.3f} s)",
                 f"  libraries already built: "
                 f"{st['persistent_cache_hits']}",
                 f"  jaxpr traces: no counterpart (to_static captures "
                 f"with torch.export: "
                 f"{sum(v['traces'] for v in st['functions'].values())}, "
                 f"retraces {st['retraces']})"]
        for name, e in sorted(st["sources"].items()):
            lines.append(f"    {name[:40]:<40} {e['builds']:>3} builds "
                         f"{e['seconds']:>9.3f} s {e['cache_hits']:>4} "
                         f"cached")
        return lines

    def summary_table(self, sorted_by="total", time_unit="ms") -> str:
        """Host-span stats (name / calls / total / avg / max / % of the
        steps' wall), then the sections the port has: Compilation,
        Memory, Numerics, checkpoints, runtime, Serving and Fleet.  The
        reference's autotune and lint sections belong to its analysis
        layer (ROADMAP A5) and are not here."""
        units = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}
        unit = units.get(time_unit, 1e3)
        if time_unit not in units:
            time_unit = "ms"
        wall = sum(self._step_times) or sum(
            t for _, t, _ in self._span_stats.values()) or 1e-12
        rows = [(name, c, tot, tot / c, mx)
                for name, (c, tot, mx) in self._span_stats.items()]
        key = {"total": 2, "calls": 1, "avg": 3, "max": 4}.get(sorted_by, 2)
        rows.sort(key=lambda r: -r[key])
        header = (f"{'Name':<32}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
                  f"{'Avg(' + time_unit + ')':>12}"
                  f"{'Max(' + time_unit + ')':>12}{'Ratio%':>8}")
        rule = "-" * len(header)
        lines = [rule, header, rule]
        for name, c, tot, avg, mx in rows:
            lines.append(
                f"{name[:32]:<32}{c:>8}{tot * unit:>14.3f}"
                f"{avg * unit:>12.3f}{mx * unit:>12.3f}"
                f"{100.0 * tot / wall:>8.1f}")
        from .. import runtime as _runtime
        from ..distributed import fault_tolerance as _ft
        from ..serving import autoscale as _autoscale
        from ..serving import engine as _serving
        for section in (self._compilation_section(), xmem.summary_lines(),
                        numerics.summary_lines(), _ft.summary_lines(),
                        _runtime.summary_lines(), _serving.summary_lines(),
                        _autoscale.fleet_summary_lines()):
            lines.append(rule)
            lines.extend(section)
        lines.append(rule)
        if self._step_times:
            lines.append(self.step_info(time_unit))
        return "\n".join(lines)

    def summary(self, sorted_by="total", op_detail=True, thread_sep=False,
                time_unit="ms"):
        print(self.summary_table(sorted_by=sorted_by if isinstance(
            sorted_by, str) else "total", time_unit=time_unit), flush=True)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class benchmark:
    """Step timer: per-step seconds and samples over the run (the
    reference's ``profiler/timer.py``); ``clock`` is injectable."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._times = []
        self._samples = []
        self._last = None

    def begin(self):
        self._last = self._clock()

    def step(self, num_samples=None):
        now = self._clock()
        if self._last is not None:
            self._times.append(now - self._last)
            self._samples.append(num_samples or 1)
        self._last = now

    def end(self):
        pass

    def report(self):
        import numpy as np
        arr = np.asarray(self._times or [0.0])
        n = float(np.sum(self._samples)) if self._samples else 0.0
        total = float(np.sum(arr)) or 1e-12
        return {"avg_s": float(arr.mean()), "steps": len(self._times),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "max_s": float(arr.max()),
                "ips": n / total,
                "steps_per_sec": len(self._times) / total}
