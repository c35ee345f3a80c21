"""Framework metrics registry: Counter / Gauge / Histogram (the port's
copy of ``paddle_tpu/profiler/metrics.py``: the same names, buckets,
snapshot and Prometheus text).

Process-global, thread-safe (the exporter thread scrapes while the
engine steps), and cheap enough to leave the call sites in every hot
path.

Gating contract: every recording call first runs `enabled()` — one dict
lookup plus a boolean check against the ``FLAGS_tpu_metrics`` flag — and
returns immediately when metrics are off. No locks, no allocation, no
string formatting on the disabled path. Call sites that need to skip
even argument construction guard with ``if metrics.enabled():``
themselves.

Exports: `snapshot()` (plain dict), `to_json()`, and `to_prometheus()`
(text exposition format 0.0.4).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

from .. import flags as _flags

__all__ = ["Counter", "Gauge", "Histogram", "enabled", "counter", "gauge",
           "histogram", "snapshot", "to_json", "to_prometheus", "reset",
           "DEFAULT_BUCKETS"]

# direct reference to the flag registry dict: enabled() must cost one
# dict lookup + bool check, never a function-call chain through get_flags
_FLAG_DICT = _flags._REGISTRY
_FLAG_NAME = "FLAGS_tpu_metrics"


def enabled() -> bool:
    """Whether metric recording is on (the only check hot paths pay)."""
    return bool(_FLAG_DICT.get(_FLAG_NAME, False))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_str: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_str
        self.labels = _label_key(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing count (calls, bytes, retraces...)."""

    kind = "counter"

    def __init__(self, name, help_str="", labels=None):
        super().__init__(name, help_str, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if not enabled():
            return
        if amount < 0:
            raise ValueError(f"Counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self):
        return self._value


class Gauge(_Metric):
    """Point-in-time value (queue depth, cache size, live workers)."""

    kind = "gauge"

    def __init__(self, name, help_str="", labels=None):
        super().__init__(name, help_str, labels)
        self._value = 0.0

    def set(self, value: float):
        if not enabled():
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not enabled():
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self):
        return self._value


# latency-oriented default: 100us .. ~100s, roughly x3 per step
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                   1.0, 3.0, 10.0, 30.0, 100.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram with count/sum/max and approximate
    percentiles (read off the bucket CDF, reported as the bucket's
    upper bound — the Prometheus `histogram_quantile` convention)."""

    kind = "histogram"

    def __init__(self, name, help_str="", labels=None, buckets=None):
        super().__init__(name, help_str, labels)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, value: float):
        if not enabled():
            return
        with self._lock:
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100])."""
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = math.ceil(self._count * q / 100.0)
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += self._counts[i]
                if cum >= rank:
                    return ub
            return self._max  # landed in the +Inf bucket

    def _snapshot(self):
        return {"count": self._count, "sum": self._sum, "max": self._max,
                "avg": self._sum / self._count if self._count else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class MetricRegistry:
    """Process-global name->(labelset->metric) store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}

    def _get_or_create(self, cls, name, help_str, labels, **kw):
        key = (name, _label_key(labels or {}))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_str, labels, **kw)
                self._metrics[key] = m
            return m

    def counter(self, name, help_str="", **labels) -> Counter:
        return self._get_or_create(Counter, name, help_str, labels)

    def gauge(self, name, help_str="", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help_str, labels)

    def histogram(self, name, help_str="", buckets=None,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, help_str, labels,
                                   buckets=buckets)

    def snapshot(self) -> dict:
        """Plain-dict view: name -> value, or name{labels} -> value for
        labeled series; histograms expand to a stats sub-dict."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), m in items:
            out[name + _format_labels(labels)] = m._snapshot()
        return out

    def to_json(self, **dump_kwargs) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **dump_kwargs)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            items = list(self._metrics.items())
        by_name: Dict[str, List[Tuple[Tuple, _Metric]]] = {}
        for (name, labels), m in items:
            by_name.setdefault(name, []).append((labels, m))
        lines: List[str] = []
        for name in sorted(by_name):
            series = by_name[name]
            kind = series[0][1].kind
            help_str = next((m.help for _, m in series if m.help), "")
            if help_str:
                lines.append(f"# HELP {name} {help_str}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in sorted(series, key=lambda s: s[0]):
                if isinstance(m, Histogram):
                    cum = 0
                    for i, ub in enumerate(m.buckets):
                        cum += m._counts[i]
                        lbl = _format_labels(labels + (("le", repr(ub)),))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    lbl = _format_labels(labels + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lbl} {m._count}")
                    lines.append(
                        f"{name}_sum{_format_labels(labels)} {m._sum}")
                    lines.append(
                        f"{name}_count{_format_labels(labels)} {m._count}")
                else:
                    lines.append(
                        f"{name}{_format_labels(labels)} {m._value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Drop all metrics (tests / between benchmark cases)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricRegistry()

# module-level conveniences bound to the global registry
counter = _REGISTRY.counter
gauge = _REGISTRY.gauge
histogram = _REGISTRY.histogram
snapshot = _REGISTRY.snapshot
to_json = _REGISTRY.to_json
to_prometheus = _REGISTRY.to_prometheus
reset = _REGISTRY.reset
