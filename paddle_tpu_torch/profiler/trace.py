"""Structured event/span tracing: the flight recorder (the port's copy
of ``paddle_tpu/profiler/trace.py``; its sidecars are byte-compatible
with the reference's and read by ``tools/trace_report.py``).

Ring-buffered structured events with monotonic timestamps, rank /
replica / request tags, span nesting and an injectable clock, gated by
``FLAGS_tpu_trace`` with the same dict-lookup-only disabled path as
``FLAGS_tpu_metrics`` — a call site pays one dict lookup + bool when
tracing is off.

Two event families share the buffer:

* **spans** — ``with span("serve/step"): ...`` records one event with
  ``t``/``dur``/``depth``/``parent`` (thread-local nesting stack);
* **request lifecycle** — ``request_event(phase, rid, ...)`` marks the
  serving transitions (queued → admitted → prefill/decode → terminal),
  from which :func:`request_timeline` / ``tools/trace_report.py``
  rebuild any request's history and a TTFT breakdown.

Router events (``route/*``) and engine recoveries are instant events.
Per-process persistence is a rank-tagged JSONL **sidecar**
(:func:`write_sidecar` / :func:`read_sidecar`); :func:`merge_sidecars`
aligns ranks on shared :func:`barrier` events into one timeline, and
:func:`chrome_events` converts any event list into Chrome trace_event
dicts (Perfetto-loadable).

The pipeline's 1F1B schedule log (:func:`record_pipeline_schedule`,
read back by :func:`pipeline_schedule_events`) stores each scheduled
unit verbatim, so ``tools/trace_report.py``'s ``pipeline_overlap``
scores a port sidecar with the simulator's own rule.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .. import flags as _flags

__all__ = [
    "enabled", "event", "span", "barrier", "request_event", "events",
    "clear", "set_clock", "set_ring_capacity", "ring_capacity",
    "TraceRecorder",
    "request_timeline", "TERMINAL_PHASES", "write_sidecar", "read_sidecar",
    "merge_ranks", "merge_sidecars", "chrome_events", "sidecar_path",
    "record_pipeline_schedule", "pipeline_schedule_events", "SCHEMA",
]

# Same discipline as profiler.metrics: the disabled path must cost one
# dict lookup + bool, nothing else — no attribute chains, no imports.
_FLAG_DICT = _flags._REGISTRY
_FLAG_NAME = "FLAGS_tpu_trace"

SCHEMA = "paddle_tpu.trace.v1"
TERMINAL_PHASES = ("finish", "cancelled", "failed")

_DEFAULT_CAPACITY = int(os.environ.get("PADDLE_TPU_TRACE_RING_CAP",
                                       "65536") or 65536)


def enabled() -> bool:
    """Is structured tracing on? (``FLAGS_tpu_trace``)"""
    return bool(_FLAG_DICT.get(_FLAG_NAME, False))


def _env_rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


class _NullSpan:
    """Returned by :func:`span` when tracing is disabled — one shared
    instance, so the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_fields", "_t0", "_depth", "_parent")

    def __init__(self, rec: "TraceRecorder", name: str, fields: dict):
        self._rec = rec
        self._name = name
        self._fields = fields

    def __enter__(self):
        stack = self._rec._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._t0 = self._rec._clock()
        return self

    def __exit__(self, *exc):
        dur = self._rec._clock() - self._t0
        stack = self._rec._stack()
        if stack and stack[-1] == self._name:
            stack.pop()
        self._rec._append(self._name, "span", self._t0, dur=dur,
                          depth=self._depth, parent=self._parent,
                          **self._fields)
        return False


class TraceRecorder:
    """A bounded, thread-safe event ring with an injectable monotonic
    clock. The module keeps one process-wide instance; tests build their
    own with a fake clock / tiny capacity."""

    def __init__(self, capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rank: Optional[int] = None):
        self._capacity = int(capacity if capacity is not None
                             else _DEFAULT_CAPACITY)
        self._clock = clock
        self._rank = _env_rank() if rank is None else int(rank)
        self._events: deque = deque(maxlen=self._capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0
        self._dropped = 0

    # -- internals ---------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _append(self, name: str, kind: str, t: float, **fields) -> dict:
        ev: Dict[str, Any] = {"name": name, "kind": kind, "t": float(t),
                              "rank": self._rank}
        ev.update(fields)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self._capacity:
                self._dropped += 1
            self._events.append(ev)
        return ev

    # -- recording API -----------------------------------------------

    def event(self, name: str, kind: str = "instant",
              t: Optional[float] = None, **fields) -> dict:
        """Record one instant event. ``t`` overrides the clock so call
        sites that already hold a timestamp (the serving engine's
        per-step ``now``) record exactly that value."""
        return self._append(name, kind, self._clock() if t is None else t,
                            **fields)

    def span(self, name: str, **fields) -> _Span:
        """Context manager: one event with ``dur`` on exit, nested via a
        thread-local stack (``depth``/``parent``)."""
        return _Span(self, name, fields)

    def barrier(self, name: str, **fields) -> dict:
        """A cross-rank alignment point: every rank records the same
        barrier name at its local clock; :func:`merge_ranks` shifts
        clocks so these coincide."""
        return self.event(name, kind="barrier", **fields)

    # -- inspection --------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped = 0

    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def set_rank(self, rank: int) -> None:
        self._rank = int(rank)

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring, keeping the newest events."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        with self._lock:
            self._capacity = capacity
            self._events = deque(self._events, maxlen=capacity)

    def capacity(self) -> int:
        return self._capacity


_RECORDER = TraceRecorder()


# ---------------------------------------------------------------------------
# module-level conveniences (bound to the process recorder)
# ---------------------------------------------------------------------------

def event(name: str, kind: str = "instant", t: Optional[float] = None,
          **fields) -> Optional[dict]:
    if not _FLAG_DICT.get(_FLAG_NAME, False):
        return None
    return _RECORDER.event(name, kind=kind, t=t, **fields)


def span(name: str, **fields):
    if not _FLAG_DICT.get(_FLAG_NAME, False):
        return _NULL_SPAN
    return _RECORDER.span(name, **fields)


def barrier(name: str, **fields) -> Optional[dict]:
    if not _FLAG_DICT.get(_FLAG_NAME, False):
        return None
    return _RECORDER.barrier(name, **fields)


def request_event(phase: str, rid: str, t: Optional[float] = None,
                  **fields) -> Optional[dict]:
    """One serving-lifecycle transition for request ``rid``. ``phase``
    is queued / admitted / prefill / decode / first_token / preempted /
    replay / shed / prefix_hit / spec / recovery / quarantine /
    deadline_expired, or a terminal phase from ``TERMINAL_PHASES``."""
    if not _FLAG_DICT.get(_FLAG_NAME, False):
        return None
    return _RECORDER.event(f"serve/{phase}", kind="request", t=t,
                           rid=rid, phase=phase, **fields)


def events() -> List[dict]:
    return _RECORDER.events()


def clear() -> None:
    _RECORDER.clear()


def set_clock(clock: Callable[[], float]) -> None:
    _RECORDER.set_clock(clock)


def set_ring_capacity(capacity: int) -> None:
    _RECORDER.set_capacity(capacity)


def ring_capacity() -> int:
    return _RECORDER.capacity()


# ---------------------------------------------------------------------------
# request timelines
# ---------------------------------------------------------------------------

def request_timeline(rid: str,
                     evs: Optional[Iterable[dict]] = None) -> List[dict]:
    """All lifecycle events for one request, in record order."""
    src = _RECORDER.events() if evs is None else evs
    return [e for e in src
            if e.get("kind") == "request" and e.get("rid") == rid]


# ---------------------------------------------------------------------------
# pipeline schedule events (measured-overlap source)
# ---------------------------------------------------------------------------

def record_pipeline_schedule(pp: int, n_micro: int, *, overlap: bool,
                             step: Optional[int] = None,
                             recorder: Optional[TraceRecorder] = None
                             ) -> Optional[int]:
    """Emit the 1F1B schedule log of one *executed* pipeline step into
    the trace. The schedule is fully determined by (pp, n_micro,
    overlap) — the same arithmetic ``pipeline.pipeline_1f1b_value_and_grad``
    runs its tick loop on — so the host-side log is exact, not sampled. Each schedule event is stored
    verbatim under the ``ev`` key; ``tools/trace_report.py`` recomputes
    ``transfer_stats``/``overlap_fraction`` from those dicts with the
    simulator's own serialization rule. Returns the number of schedule
    events recorded, or None when tracing is off."""
    if not _FLAG_DICT.get(_FLAG_NAME, False):
        return None
    from ..distributed.overlap import schedule_events
    evs = schedule_events(int(pp), int(n_micro), overlap=bool(overlap))
    rec = _RECORDER if recorder is None else recorder
    rec.event("pipeline/schedule", kind="pipeline_meta", pp=int(pp),
              n_micro=int(n_micro), overlap=bool(overlap), step=step,
              n_events=len(evs))
    for e in evs:
        rec.event(f"pipeline/{e['kind']}", kind="pipeline", step=step,
                  ev=dict(e))
    return len(evs)


def pipeline_schedule_events(evs: Optional[Iterable[dict]] = None,
                             step: Optional[int] = None) -> List[dict]:
    """Extract the raw schedule-event dicts back out of a trace (the
    inverse of :func:`record_pipeline_schedule`), sorted with the
    simulator's key so ordering comparisons are bit-equal."""
    src = _RECORDER.events() if evs is None else evs
    out = [dict(e["ev"]) for e in src
           if e.get("kind") == "pipeline"
           and (step is None or e.get("step") == step)]
    out.sort(key=lambda e: (e["tick"], e["stage"] if "stage" in e
                            else e["src"]))
    return out


# ---------------------------------------------------------------------------
# JSONL sidecars + multi-rank merge
# ---------------------------------------------------------------------------

def sidecar_path(base_dir: str = ".", rank: Optional[int] = None) -> str:
    """Default per-process sidecar path: ``trace_rank<N>.jsonl``."""
    r = _env_rank() if rank is None else int(rank)
    return os.path.join(base_dir, f"trace_rank{r}.jsonl")


def write_sidecar(path: str, evs: Optional[Iterable[dict]] = None,
                  rank: Optional[int] = None,
                  extra: Optional[dict] = None) -> str:
    """Write a rank-tagged JSONL sidecar: one header line (schema, rank,
    pid, wall time, drop count) then one event per line. Atomic via
    tmp-file + rename so a crash mid-dump never leaves a torn file."""
    from_recorder = evs is None
    if from_recorder:
        evs = _RECORDER.events()
    header: Dict[str, Any] = {
        "schema": SCHEMA,
        "rank": _RECORDER._rank if rank is None else int(rank),
        "pid": os.getpid(),
        "wall_time": time.time(),
        "dropped": _RECORDER.dropped() if from_recorder else 0,
    }
    if extra:
        header.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for e in evs:
            f.write(json.dumps(e, sort_keys=True, default=str) + "\n")
    os.replace(tmp, path)
    return path


def read_sidecar(path: str) -> Tuple[dict, List[dict]]:
    """Load ``(header, events)`` from a sidecar written by
    :func:`write_sidecar`. Raises ValueError on a torn/corrupt file."""
    with open(path) as f:
        lines = [ln for ln in (raw.strip() for raw in f) if ln]
    if not lines:
        raise ValueError(f"{path}: empty trace sidecar")
    try:
        header = json.loads(lines[0])
        evs = [json.loads(ln) for ln in lines[1:]]
    except json.JSONDecodeError as exc:
        raise ValueError(f"{path}: corrupt trace sidecar: {exc}") from exc
    if not isinstance(header, dict) or header.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} sidecar "
                         f"(header={header!r})")
    return header, evs


def merge_ranks(per_rank: Dict[int, List[dict]]) -> List[dict]:
    """Merge per-rank event lists into one timeline. Ranks run on
    unsynchronised monotonic clocks; alignment uses the first barrier
    event (``kind == "barrier"``) whose name every rank recorded — each
    rank's clock is shifted so that barrier lands at the reference
    (lowest) rank's timestamp. Without a shared barrier, clocks are
    taken as-is. Events gain the owning ``rank`` tag and sort by
    ``(t, rank, seq)``."""
    if not per_rank:
        return []
    ranks = sorted(per_rank)
    ref = ranks[0]
    barriers: Dict[int, Dict[str, float]] = {}
    for r in ranks:
        names: Dict[str, float] = {}
        for e in per_rank[r]:
            if e.get("kind") == "barrier" and e["name"] not in names:
                names[e["name"]] = e["t"]
        barriers[r] = names
    shared = None
    for e in per_rank[ref]:
        if e.get("kind") == "barrier" and all(
                e["name"] in barriers[r] for r in ranks):
            shared = e["name"]
            break
    merged: List[dict] = []
    for r in ranks:
        offset = 0.0
        if shared is not None:
            offset = barriers[ref][shared] - barriers[r][shared]
        for e in per_rank[r]:
            out = dict(e)
            out["t"] = e["t"] + offset
            out["rank"] = r
            merged.append(out)
    merged.sort(key=lambda e: (e["t"], e["rank"], e.get("seq", 0)))
    return merged


def merge_sidecars(paths: Iterable[str]) -> List[dict]:
    """Read several rank sidecars and :func:`merge_ranks` them."""
    per_rank: Dict[int, List[dict]] = {}
    for p in paths:
        header, evs = read_sidecar(p)
        per_rank.setdefault(int(header.get("rank", 0)), []).extend(evs)
    return merge_ranks(per_rank)


# ---------------------------------------------------------------------------
# Chrome trace_event conversion (Perfetto-loadable)
# ---------------------------------------------------------------------------

def chrome_events(evs: Optional[Iterable[dict]] = None) -> List[dict]:
    """Convert structured events to Chrome trace_event dicts: spans
    become "X" complete events, everything else an "i" instant. ``pid``
    is the rank (so merged multi-rank traces get one track group per
    rank) and extra fields ride in ``args``."""
    src = _RECORDER.events() if evs is None else evs
    out: List[dict] = []
    for e in src:
        rank = int(e.get("rank", 0))
        args = {k: v for k, v in e.items()
                if k not in ("name", "kind", "t", "dur", "rank", "seq")}
        ch: Dict[str, Any] = {"name": e["name"], "cat": e.get("kind", ""),
                              "ts": e["t"] * 1e6, "pid": rank,
                              "tid": int(e.get("depth", 0))}
        if "dur" in e:
            ch["ph"] = "X"
            ch["dur"] = e["dur"] * 1e6
        else:
            ch["ph"] = "i"
            ch["s"] = "t"
        if args:
            ch["args"] = args
        out.append(ch)
    return out
