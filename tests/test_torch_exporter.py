"""The port's live exporter (``paddle_tpu_torch/profiler/exporter.py``)
on the reference's exporter cases (``tests/test_exporter.py``).

The disabled path is one dict lookup (``maybe_serve`` returns None
without touching a socket); ``-1`` binds an ephemeral port, a taken port
falls back to an ephemeral one, and the portfile records the bound
port; the five endpoints answer; a port engine run is scrapeable from
another thread while it steps, and the final ``/slo`` scrape equals the
engine's own ``slo_report()`` and the final ``/metrics`` scrape equals
``serving_stats()``; a router with an autoscaler exposes its burn rates
and replica states.  Every socket binds ``127.0.0.1``.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.profiler import exporter, metrics, trace
from paddle_tpu_torch.runtime import watchdog
from paddle_tpu_torch.serving.autoscale import AutoscalePolicy, ServiceModel


@pytest.fixture(autouse=True)
def _exporter_off():
    """Every test starts and ends with the exporter down, flags off."""
    old = flags.get_flags(["FLAGS_tpu_metrics_port", "FLAGS_tpu_metrics"])
    exporter.shutdown()
    yield
    flags.set_flags(old)
    exporter.shutdown()
    metrics.reset()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get_json(port, path):
    status, body = _get(port, path)
    assert status == 200, body
    return json.loads(body)


@pytest.fixture(scope="module")
def model():
    cfg = llama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, dtype=torch.float32)
    return cfg, llama.init_params(cfg, 0, device="cpu")


def _engine(model, **kw):
    cfg, params = model
    kw.setdefault("max_running", 2)
    return serving.LLMEngine(cfg, params, device="cpu", chunk=4,
                             page_size=8, max_model_len=32, **kw)


def test_disabled_path_is_inert():
    flags.set_flags({"FLAGS_tpu_metrics_port": 0})
    assert exporter.maybe_serve("engine", object()) is None
    assert exporter.active() is None


def test_engine_constructor_does_not_start_exporter_when_off(model):
    flags.set_flags({"FLAGS_tpu_metrics_port": 0})
    _engine(model)
    assert exporter.active() is None


def test_flag_minus_one_binds_ephemeral_port():
    flags.set_flags({"FLAGS_tpu_metrics_port": -1})
    exp = exporter.maybe_serve()
    assert exp is not None and exp.port > 0 and exp.host == "127.0.0.1"
    status, body = _get(exp.port, "/healthz")
    assert status == 200 and json.loads(body)["ok"]


def test_port_conflict_falls_back_to_ephemeral():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    taken = blocker.getsockname()[1]
    try:
        flags.set_flags({"FLAGS_tpu_metrics_port": taken})
        exp = exporter.maybe_serve()
        assert exp is not None
        assert exp.port != taken and exp.port > 0
        assert _get(exp.port, "/healthz")[0] == 200
    finally:
        blocker.close()


def test_portfile_records_bound_port(tmp_path, monkeypatch):
    portfile = tmp_path / "port"
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORTFILE", str(portfile))
    flags.set_flags({"FLAGS_tpu_metrics_port": -1})
    exp = exporter.maybe_serve()
    assert int(portfile.read_text()) == exp.port


def test_metrics_endpoint_serves_prometheus_text():
    flags.set_flags({"FLAGS_tpu_metrics_port": -1,
                     "FLAGS_tpu_metrics": True})
    metrics.counter("exporter_test_total", "counter under test").inc(3)
    exp = exporter.maybe_serve()
    status, body = _get(exp.port, "/metrics")
    assert status == 200
    assert "exporter_test_total 3" in body
    assert body == metrics.to_prometheus()


def test_incidents_and_trace_tail_endpoints():
    flags.set_flags({"FLAGS_tpu_metrics_port": -1})
    exp = exporter.maybe_serve()
    watchdog.record_incident("exporter_test", detail="synthetic")
    doc = _get_json(exp.port, "/incidents?n=5")
    assert doc["count"] >= 1
    assert doc["tail"][-1]["kind"] == "exporter_test"
    doc = _get_json(exp.port, "/trace/tail?n=5")
    assert doc["enabled"] is False and doc["tail"] == []
    assert _get(exp.port, "/nope")[0] == 404
    watchdog.clear_incidents()


def _scraped_counters(body):
    """Unlabelled ``serve_*_total`` samples of a Prometheus text."""
    out = {}
    for line in body.splitlines():
        if line.startswith("serve_") and "{" not in line:
            name, value = line.split()
            out[name] = float(value)
    return out


def test_concurrent_scrape_during_engine_run_matches_final_report(model):
    """Scrapes from a background thread while the engine steps never
    error; after the run ``/slo`` equals the engine's ``slo_report()``
    and ``/metrics``'s token counters equal ``serving_stats()``."""
    flags.set_flags({"FLAGS_tpu_metrics_port": -1,
                     "FLAGS_tpu_metrics": True})
    metrics.reset()
    serving.reset_stats()
    eng = _engine(model, max_running=4,
                  slo=serving.SLOConfig(ttft_p95_s=10.0,
                                        latency_p95_s=10.0))
    exp = exporter.active()
    assert exp is not None, "engine constructor must start the exporter"

    rng = np.random.RandomState(0)
    for i in range(6):
        eng.add_request(list(rng.randint(0, 128, 5 + i)), 4)

    scraped, errors = [], []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                scraped.append(_get_json(exp.port, "/slo"))
                _get(exp.port, "/metrics")
                _get(exp.port, "/healthz")
            except Exception as e:  # pragma: no cover - failure detail
                errors.append(e)
            time.sleep(0.002)

    t = threading.Thread(target=scraper, daemon=True)
    t.start()
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 500
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not errors, errors
    assert scraped, "scraper never completed a request"

    final = _get_json(exp.port, "/slo")
    (eng_view,) = final["engines"]
    own = eng.slo_report()
    assert eng_view["ttft_p95_s"] == pytest.approx(
        float(own["ttft_p95_s"]), rel=1e-6)
    assert eng_view["latency_p95_s"] == pytest.approx(
        float(own["latency_p95_s"]), rel=1e-6)
    health = _get_json(exp.port, "/healthz")
    assert health["engines"][0]["num_running"] == 0
    stats = serving.serving_stats()
    got = _scraped_counters(_get(exp.port, "/metrics")[1])
    assert got["serve_prefill_tokens_total"] == stats["prefill_tokens"]
    assert got["serve_decode_tokens_total"] == stats["decode_tokens"]
    assert got["serve_queue_depth"] == 0.0
    serving.reset_stats()


def test_router_attachment_exposes_burn_rates_and_recommendation(model):
    flags.set_flags({"FLAGS_tpu_metrics_port": -1})
    eng = _engine(model)
    clock_t = [0.0]
    sm = ServiceModel(max_running=2, chunk=4, page_size=8, num_pages=9,
                      max_model_len=32, max_queue=32)
    policy = AutoscalePolicy(sm, slo_ttft_s=0.5, clock=lambda: clock_t[0])
    router = serving.Router([("r0", eng)], autoscaler=policy,
                            clock=lambda: clock_t[0])
    exp = exporter.active()
    doc = _get_json(exp.port, "/slo")
    assert doc["router"]["live_replicas"] == ["r0"]
    assert doc["burn_rates"] is not None
    health = _get_json(exp.port, "/healthz")
    assert health["router"]["replicas"] == {"r0": "live"}
    router.submit([1, 2, 3], 2)
    router.run(max_steps=50)
    doc = _get_json(exp.port, "/slo")
    assert doc["router"]["last_recommendation"]["action"] in (
        "hold", "scale_up", "scale_down")


def test_trace_tail_serves_the_ring(model):
    flags.set_flags({"FLAGS_tpu_metrics_port": -1, "FLAGS_tpu_trace": True})
    trace.clear()
    try:
        eng = _engine(model)
        eng.add_request([1, 2, 3], 2)
        eng.run()
        exp = exporter.active()
        doc = _get_json(exp.port, "/trace/tail?n=3")
        assert doc["enabled"] is True
        assert doc["count"] == len(trace.events())
        assert doc["tail"] == json.loads(json.dumps(trace.events()[-3:]))
    finally:
        flags.set_flags({"FLAGS_tpu_trace": False})
        trace.clear()
