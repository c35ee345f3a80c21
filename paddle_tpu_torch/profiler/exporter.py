"""Live observability endpoint: /metrics, /healthz, /slo, /incidents,
/trace/tail (the port's copy of ``paddle_tpu/profiler/exporter.py``).

A stdlib ``http.server`` served from a daemon thread, gated by
``FLAGS_tpu_metrics_port``:

* ``0`` (default): disabled.  The check in :func:`maybe_serve` is one
  dict lookup + bool — zero per-step cost when observability is off.
* ``-1``: bind an ephemeral port (tests, multi-process benches).
* ``>0``: bind that port; if it is already taken (two replicas on one
  host), fall back to an ephemeral port instead of crashing the replica.

It binds ``127.0.0.1`` unless the caller of :func:`serve` names another
host.  ``PADDLE_TPU_METRICS_PORTFILE``, when set, names a file the bound
port is written to.

Routes:

* ``/metrics`` — the metric registry in Prometheus text exposition
  format (``profiler.metrics.to_prometheus``).
* ``/healthz`` — liveness: uptime, pid, watchdog incident count, per-role
  attachment state (engine running/queue depth, router replica states,
  train-loop step progress).
* ``/slo`` — every attached engine's ``slo_report()`` plus, when a router
  with an autoscaler is attached, the ``SLOBurnGauge`` burn-rate windows,
  the last autoscale recommendation and ``fleet_stats()``.
* ``/incidents?n=`` — tail of the watchdog incident buffer
  (``runtime/watchdog.py``).
* ``/trace/tail?n=`` — tail of the flight-recorder trace ring
  (``profiler/trace.py``).

``Router``, ``LLMEngine`` and ``Plan.run_train_loop`` call
:func:`maybe_serve` at construction; one process-wide exporter serves
all attached objects.  Scrapes read through the registry's own lock and
touch only snapshot-style accessors — they never block ``step()``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from .. import flags as _flags
from . import metrics as _metrics

__all__ = ["MetricsExporter", "maybe_serve", "serve", "active", "shutdown"]

# same convention as profiler.metrics: the disabled path must cost one
# dict lookup + bool check, never a call chain through get_flags
_FLAG_DICT = _flags._REGISTRY
_FLAG_NAME = "FLAGS_tpu_metrics_port"

_PORTFILE_ENV = "PADDLE_TPU_METRICS_PORTFILE"

_LOCK = threading.Lock()
_EXPORTER: Optional["MetricsExporter"] = None


def _json_default(o: Any) -> Any:
    item = getattr(o, "item", None)  # numpy scalars without importing numpy
    if callable(item):
        try:
            return item()
        except Exception:  # noqa: BLE001 — an arbitrary .item()
            pass
    return str(o)


class MetricsExporter:
    """One HTTP endpoint serving every attached engine/router/train loop."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.requested_port = port
        self.host = host
        self.port: Optional[int] = None  # bound port, set by start()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        self._attach_lock = threading.Lock()
        self._engines: List[Any] = []
        self._router: Any = None
        self._train_status: Any = None  # zero-arg callable -> dict

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "MetricsExporter":
        if self._httpd is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                exporter._handle(self)

            def log_message(self, *args):  # silence per-request stderr
                pass

        port = 0 if self.requested_port < 0 else self.requested_port
        try:
            httpd = ThreadingHTTPServer((self.host, port), Handler)
        except OSError:
            # port taken (another replica on this host): fall back to an
            # ephemeral port rather than killing the process
            httpd = ThreadingHTTPServer((self.host, 0), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._started_at = time.monotonic()
        portfile = os.environ.get(_PORTFILE_ENV)
        if portfile:
            with open(portfile, "w") as f:
                f.write(str(self.port))
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="paddle-tpu-metrics-exporter",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- attachment -------------------------------------------------------

    def attach(self, role: Optional[str], obj: Any) -> None:
        if role is None or obj is None:
            return
        with self._attach_lock:
            if role == "engine":
                if not any(e is obj for e in self._engines):
                    self._engines.append(obj)
            elif role == "router":
                self._router = obj
            elif role == "train":
                self._train_status = obj  # callable returning a dict

    # -- request handling -------------------------------------------------

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        url = urlparse(req.path)
        q = parse_qs(url.query)
        try:
            if url.path == "/metrics":
                body = _metrics.to_prometheus()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif url.path == "/healthz":
                body = json.dumps(self._healthz(), indent=2, sort_keys=True,
                                  default=_json_default)
                ctype = "application/json"
            elif url.path == "/slo":
                body = json.dumps(self._slo(), indent=2, sort_keys=True,
                                  default=_json_default)
                ctype = "application/json"
            elif url.path == "/incidents":
                n = int(q.get("n", ["50"])[0])
                body = json.dumps(self._incidents(n), indent=2,
                                  sort_keys=True, default=_json_default)
                ctype = "application/json"
            elif url.path == "/trace/tail":
                n = int(q.get("n", ["100"])[0])
                body = json.dumps(self._trace_tail(n), indent=2,
                                  sort_keys=True, default=_json_default)
                ctype = "application/json"
            else:
                req.send_response(404)
                req.send_header("Content-Type", "text/plain")
                req.end_headers()
                req.wfile.write(b"not found\n")
                return
        except Exception as e:  # a broken scrape must never kill serving
            req.send_response(500)
            req.send_header("Content-Type", "text/plain")
            req.end_headers()
            req.wfile.write(f"scrape error: {e}\n".encode())
            return
        data = body.encode()
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    # -- views ------------------------------------------------------------

    def _healthz(self) -> Dict[str, Any]:
        from ..runtime import watchdog as _watchdog
        incidents = _watchdog.incidents()
        out: Dict[str, Any] = {
            "ok": True,
            "pid": os.getpid(),
            "port": self.port,
            "uptime_s": (time.monotonic() - self._started_at
                         if self._started_at is not None else None),
            "metrics_enabled": _metrics.enabled(),
            "watchdog": {
                "incident_count": len(incidents),
                "last_incident": _watchdog.last_incident(),
            },
        }
        with self._attach_lock:
            engines = list(self._engines)
            router = self._router
            train = self._train_status
        out["engines"] = [self._engine_health(e) for e in engines]
        if router is not None:
            try:
                out["router"] = {"replicas": router.replica_states()}
            except Exception as e:
                out["router"] = {"error": str(e)}
        if train is not None:
            try:
                out["train"] = dict(train())
            except Exception as e:
                out["train"] = {"error": str(e)}
        return out

    @staticmethod
    def _engine_health(eng: Any) -> Dict[str, Any]:
        h: Dict[str, Any] = {}
        sched = getattr(eng, "scheduler", None)
        for attr in ("num_running", "num_waiting"):
            try:
                v = getattr(sched, attr, None)
                h[attr] = v() if callable(v) else v
            except Exception:
                h[attr] = None
        return h

    def _slo(self) -> Dict[str, Any]:
        with self._attach_lock:
            engines = list(self._engines)
            router = self._router
        out: Dict[str, Any] = {
            "engines": [], "router": None, "burn_rates": None,
            "fleet": None,
        }
        for eng in engines:
            try:
                out["engines"].append(eng.slo_report())
            except Exception as e:
                out["engines"].append({"error": str(e)})
        if router is not None:
            r: Dict[str, Any] = {"live_replicas": None,
                                 "last_recommendation": None}
            try:
                r["live_replicas"] = router.live_replicas()
            except Exception:  # noqa: BLE001 — a best-effort probe
                pass
            auto = getattr(router, "autoscaler", None)
            last = getattr(router, "last_recommendation", None)
            if last is not None:
                to_dict = getattr(last, "to_dict", None)
                r["last_recommendation"] = (to_dict() if callable(to_dict)
                                            else last)
            if auto is not None:
                gauge = getattr(auto, "gauge", None)
                clock = getattr(auto, "_clock", time.monotonic)
                if gauge is not None:
                    try:
                        out["burn_rates"] = gauge.burn_rates(clock())
                    except Exception as e:
                        out["burn_rates"] = {"error": str(e)}
                fleet_stats = getattr(auto, "fleet_stats", None)
                if callable(fleet_stats):
                    try:
                        out["fleet"] = fleet_stats()
                    except Exception as e:
                        out["fleet"] = {"error": str(e)}
            out["router"] = r
        return out

    def _incidents(self, n: int) -> Dict[str, Any]:
        from ..runtime import watchdog as _watchdog
        incidents = _watchdog.incidents()
        return {"count": len(incidents), "tail": incidents[-max(n, 0):]}

    def _trace_tail(self, n: int) -> Dict[str, Any]:
        from . import trace as _trace
        events = _trace.events()
        return {"enabled": _trace.enabled(), "count": len(events),
                "tail": events[-max(n, 0):]}


# ---------------------------------------------------------------------------
# module-level singleton
# ---------------------------------------------------------------------------

def active() -> Optional[MetricsExporter]:
    """The running process-wide exporter, or None."""
    return _EXPORTER


def serve(port: Optional[int] = None, host: str = "127.0.0.1",
          role: Optional[str] = None, obj: Any = None) -> MetricsExporter:
    """Start (or reuse) the process-wide exporter and optionally attach."""
    global _EXPORTER
    with _LOCK:
        if _EXPORTER is None:
            if port is None:
                port = int(_FLAG_DICT.get(_FLAG_NAME, 0) or 0)
            _EXPORTER = MetricsExporter(port, host=host).start()
        exp = _EXPORTER
    exp.attach(role, obj)
    return exp


def maybe_serve(role: Optional[str] = None,
                obj: Any = None) -> Optional[MetricsExporter]:
    """Start/attach the exporter iff FLAGS_tpu_metrics_port is set.

    The disabled path is one dict lookup + bool check — safe to call from
    every Engine and Router constructor.
    """
    if not _FLAG_DICT.get(_FLAG_NAME, 0):
        return None
    return serve(role=role, obj=obj)


def shutdown() -> None:
    """Stop the process-wide exporter (tests)."""
    global _EXPORTER
    with _LOCK:
        exp, _EXPORTER = _EXPORTER, None
    if exp is not None:
        exp.stop()
