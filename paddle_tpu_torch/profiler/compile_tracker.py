"""Compile accounting (the port of ``paddle_tpu/profiler/compile_tracker.py``).

The port has no XLA: what it compiles is its CUDA kernels, one nvcc
build a source (``ops/_build.py``).  Each build reports here with its
seconds; a library already built for the current source and headers is
a cache hit.  ``jit.to_static`` records each capture of a new call
signature (``record_trace``: the first of a function is its capture,
later ones are retraces), as the reference records its jaxpr traces.
``stats()`` feeds the Profiler's "Compilation" section; with
FLAGS_tpu_metrics on the same events count in ``kernel_builds_total``,
``kernel_build_seconds_total``, ``kernel_build_cache_hits_total``,
``jit_traces_total`` and ``jit_retraces_total``.
"""
from __future__ import annotations

import threading
from typing import Dict

from . import metrics as _metrics

__all__ = ["record_build", "record_cache_hit", "record_trace", "stats",
           "reset", "compile_count", "compile_seconds"]

_lock = threading.Lock()
_totals = {"compile_count": 0, "compile_seconds": 0.0,
           "persistent_cache_hits": 0, "persistent_cache_misses": 0}
# source name -> {"builds": n, "seconds": s, "cache_hits": n}
_sources: Dict[str, Dict[str, float]] = {}
# to_static function name -> {"traces": n, "retraces": n}
_functions: Dict[str, Dict[str, int]] = {}


def _entry(name: str) -> Dict[str, float]:
    return _sources.setdefault(name, {"builds": 0, "seconds": 0.0,
                                      "cache_hits": 0})


def record_build(name: str, seconds: float) -> None:
    """One nvcc build of ``ops/csrc/<name>.cu`` that took ``seconds``
    (a cache miss)."""
    with _lock:
        _totals["compile_count"] += 1
        _totals["compile_seconds"] += float(seconds)
        _totals["persistent_cache_misses"] += 1
        e = _entry(name)
        e["builds"] += 1
        e["seconds"] += float(seconds)
    if _metrics.enabled():
        _metrics.counter("kernel_builds_total",
                         "nvcc builds of the port's kernels",
                         source=name).inc()
        _metrics.counter("kernel_build_seconds_total",
                         "Cumulative nvcc build seconds",
                         source=name).inc(float(seconds))


def record_cache_hit(name: str) -> None:
    """A library of ``name`` already built for the current source."""
    with _lock:
        _totals["persistent_cache_hits"] += 1
        _entry(name)["cache_hits"] += 1
    if _metrics.enabled():
        _metrics.counter("kernel_build_cache_hits_total",
                         "Kernel libraries found built for the current "
                         "source", source=name).inc()


def record_trace(fn_name: str) -> None:
    """One capture of a new call signature of ``fn_name`` (a
    ``to_static`` function); every one after the first is a retrace."""
    with _lock:
        entry = _functions.setdefault(fn_name, {"traces": 0, "retraces": 0})
        entry["traces"] += 1
        is_retrace = entry["traces"] > 1
        if is_retrace:
            entry["retraces"] += 1
    if _metrics.enabled():
        _metrics.counter("jit_traces_total",
                         "Captures per to_static function", fn=fn_name).inc()
        if is_retrace:
            _metrics.counter("jit_retraces_total",
                             "Captures after the first",
                             fn=fn_name).inc()


def compile_count() -> int:
    return _totals["compile_count"]


def compile_seconds() -> float:
    return _totals["compile_seconds"]


def stats() -> dict:
    """Snapshot of the build totals and the builds by source."""
    with _lock:
        out = dict(_totals)
        out["sources"] = {k: dict(v) for k, v in _sources.items()}
        out["functions"] = {k: dict(v) for k, v in _functions.items()}
        out["retraces"] = sum(v["retraces"] for v in _functions.values())
    return out


def reset():
    with _lock:
        for k in _totals:
            _totals[k] = 0 if isinstance(_totals[k], int) else 0.0
        _sources.clear()
        _functions.clear()
