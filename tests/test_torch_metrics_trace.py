"""The port's metrics registry and flight recorder against the JAX
package's.

Under the same flags, the same injected faults and the same fake clock,
the JAX engine and the port's engine must leave the same observability
record, exactly: the Prometheus text of the metric registry (every name,
label set, counter and gauge value and histogram bucket), the flight
recorder's events (request lifecycles, step spans, recoveries) with
their timestamps, and the incident a deadline expiry dumps with the
request's timeline.  The scenarios cover queueing, preemption, crash
recovery with replay, a bisection quarantine, a deadline expiry and
speculative decoding over the prefix cache.  A sidecar the port writes
is read by the reference's ``read_sidecar`` and by
``tools/trace_report.py``, whose TTFT breakdown equals the engine's
own TTFT; ``chrome_events`` and the recorder's ring agree with the
reference's.  The JAX side runs its Pallas kernels in interpret mode.
"""
import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import pallas_ops
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu.runtime import watchdog as jwdog
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import trace as ttrace
from paddle_tpu_torch.runtime import watchdog as twdog
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_REPORT = os.path.join(REPO, "tools", "trace_report.py")
OBS = {"FLAGS_tpu_metrics": True, "FLAGS_tpu_trace": True}
OFF = {"FLAGS_tpu_metrics": False, "FLAGS_tpu_trace": False}


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _reset_all():
    for mod in (jmetrics, tmetrics):
        mod.reset()
    for mod in (jtrace, ttrace):
        mod.clear()
        mod.set_clock(time.monotonic)
    for mod in (jwdog, twdog):
        mod.clear_incidents()
    jserving.reset_stats()
    tserving.reset_stats()


@pytest.fixture
def obs():
    """Metrics and trace on in both packages, on clean registries."""
    _reset_all()
    jflags.set_flags(OBS)
    tflags.set_flags(OBS)
    yield
    jflags.set_flags(OFF)
    tflags.set_flags(OFF)
    _reset_all()


def _jax_cfg():
    return jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, dtype=jnp.float32, use_remat=False)


def _port_cfg(cfg):
    return tllama.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        dtype=torch.float32, quantized=cfg.quantized)


@pytest.fixture(scope="module")
def model():
    cfg = _jax_cfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, tparams


def _prompts(n=6, seed=11):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 128, rng.randint(3, 10))]
            for _ in range(n)]


def _shared_prompts():
    rng = np.random.RandomState(5)
    head = [int(t) for t in rng.randint(1, 127, 13)]
    return [head + [int(t) for t in rng.randint(1, 127, 3 + i % 3)]
            for i in range(4)]


KW = dict(max_running=4, chunk=4, page_size=8, max_model_len=32)

# name -> (engine kwargs, prompts, new tokens, chaos rule or None)
SCENARIOS = {
    "queue": (dict(KW, max_running=2), _prompts(), 5, None),
    "preempt": (dict(KW, max_running=2),
                [list(range(1, 8)), list(range(1, 8))], 6,
                "exhaust@serve.step:step=2,times=1"),
    "recover": (dict(KW, prefix_cache=True), _shared_prompts(), 5,
                "fail@serve.step:step=2,times=1"),
    "quarantine": (KW, _prompts(), 4, "fail@serve.step:rid={rid}"),
    "deadline": (KW, _prompts(4), 6, None),
    "spec_prefix": (dict(KW, prefix_cache=True), _shared_prompts(), 6,
                    None),
}


# the JAX package's compile tracker counts its XLA compiles into the same
# registry (``jit_*``); the port compiles nothing, so those series have no
# counterpart and are left out of the comparison
JIT = "jit_"


def _no_jit(text):
    def name(line):
        tok = line.split()
        return tok[2] if line.startswith("#") else tok[0].split("{")[0]
    return "".join(ln + "\n" for ln in text.splitlines()
                   if not name(ln).startswith(JIT))


def _run(side, model, name):
    """One scenario on one package's engine; returns what it recorded,
    with engine-local request ids replaced by submission order."""
    cfg, params, tparams = model
    kw, prompts, n_new, rule = SCENARIOS[name]
    kw = dict(kw)
    jax_side = side == "jax"
    trace, metrics, chaos, wdog = ((jtrace, jmetrics, jchaos, jwdog)
                                   if jax_side else
                                   (ttrace, tmetrics, tchaos, twdog))
    clk = _FakeClock(10.0)
    trace.set_clock(clk)
    if name == "spec_prefix":
        kw["spec"] = (jserving.SpecDecodeConfig(cfg=cfg, params=params, k=3)
                      if jax_side else
                      tserving.SpecDecodeConfig(_port_cfg(cfg), tparams, k=3))
    if jax_side:
        eng = jserving.LLMEngine(cfg, params, donate_pools=False, clock=clk,
                                 **kw)
    else:
        eng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu",
                                 clock=clk, **kw)
    rids = []
    for i, p in enumerate(prompts):
        dl = 0.035 if name == "deadline" and i == 1 else None
        rids.append(eng.add_request(p, n_new, deadline_s=dl))
    spec = rule.format(rid=rids[2 % len(rids)]) if rule else ""
    with chaos.installed(chaos.Chaos(spec)) as c:
        steps = 0
        while eng.has_work():
            clk.advance(0.01)
            eng.step()
            steps += 1
            if name == "preempt" and steps == 7:
                c.release_exhausted()
            assert steps < 500
    index = {rid: i for i, rid in enumerate(rids)}

    def norm(value):
        if isinstance(value, dict):
            out = {k: norm(v) for k, v in value.items() if k != "seq"}
            for key in ("rid", "culprit"):
                if out.get(key) in index:
                    out[key] = f"#{index[out[key]]}"
            return out
        if isinstance(value, list):
            return [norm(v) for v in value]
        if isinstance(value, str):
            return re.sub(r"request (\d+)",
                          lambda m: f"request #{index.get(int(m[1]), '?')}",
                          value)
        return value

    incidents = [norm({k: v for k, v in r.items()
                       if k not in ("time", "pid")})
                 for r in wdog.incidents()]
    return {"prometheus": _no_jit(metrics.to_prometheus()),
            "snapshot": {k: v for k, v in metrics.snapshot().items()
                         if not k.startswith(JIT)},
            "events": norm(trace.events()),
            "timelines": [norm(eng.request_timeline(r)) for r in rids],
            "streams": [eng.output_of(r) for r in rids],
            "states": [eng.state_of(r).value for r in rids],
            "incidents": incidents}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_observability_equals_jax(model, obs, name):
    want = _run("jax", model, name)
    _reset_all()
    got = _run("port", model, name)
    assert got["streams"] == want["streams"]
    assert got["states"] == want["states"]
    assert got["prometheus"] == want["prometheus"]
    assert got["snapshot"] == want["snapshot"]
    assert got["timelines"] == want["timelines"]
    assert got["events"] == want["events"]
    assert got["incidents"] == want["incidents"]
    # every admitted request ends in exactly one terminal event
    for tl in got["timelines"]:
        phases = [e["phase"] for e in tl]
        assert phases[0] == "queued"
        assert sum(p in ttrace.TERMINAL_PHASES for p in phases) == 1
    names = {e["name"] for e in got["events"]}
    assert "serve/step" in names
    if name in ("recover", "quarantine"):
        assert "serve/recovery" in names
        assert any(e.get("phase") == "replay" for e in got["events"])
    if name == "preempt":
        assert any("preempted" in [e["phase"] for e in tl]
                   for tl in got["timelines"])
    if name == "spec_prefix":
        assert any(e.get("phase") == "spec" for e in got["events"])
        assert "serve_spec_proposed_total" in got["prometheus"]
    if name == "deadline":
        (rec,) = [r for r in got["incidents"]
                  if r["kind"] == "serve_deadline_expired"]
        assert rec["rid"] == "#1"
        assert [e["phase"] for e in rec["timeline"]] == [
            e["phase"] for e in got["timelines"][1]]
        assert got["states"][1] == "failed"


def test_disabled_paths_record_nothing(model):
    _reset_all()
    cfg, _, tparams = model
    eng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu", **KW)
    rid = eng.add_request([1, 2, 3], 3)
    eng.run()
    assert tmetrics.snapshot() == {}
    assert ttrace.events() == [] and eng.request_timeline(rid) == []
    assert ttrace.event("x") is None and ttrace.barrier("b") is None
    with ttrace.span("s") as sp:
        assert sp is ttrace._NULL_SPAN
    tmetrics.counter("c").inc()
    assert tmetrics.counter("c").value == 0.0


def _registry_ops(m):
    """One sequence of registry calls (run with metrics on)."""
    m.counter("req_total", "requests", route="a").inc()
    m.counter("req_total", "requests", route="a").inc(2.5)
    m.counter("req_total", "requests", route="b").inc()
    g = m.gauge("depth", "queue depth")
    g.set(4)
    g.dec()
    h = m.histogram("lat_seconds", "latency")
    for v in (5e-5, 2e-4, 0.02, 0.02, 0.5, 7.0, 250.0):
        h.observe(v)
    hb = m.histogram("size", buckets=(1, 10, 100))
    for v in (0, 3, 30, 300):
        hb.observe(v)
    with pytest.raises(ValueError):
        m.counter("req_total", route="a").inc(-1)
    with pytest.raises(TypeError):
        m.gauge("req_total", route="a")
    return (m.to_prometheus(), m.snapshot(), m.to_json(),
            [h.percentile(q) for q in (0, 25, 50, 90, 99, 100)])


def test_registry_equals_jax():
    _reset_all()
    jflags.set_flags({"FLAGS_tpu_metrics": True})
    tflags.set_flags({"FLAGS_tpu_metrics": True})
    try:
        assert _registry_ops(tmetrics) == _registry_ops(jmetrics)
        assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    finally:
        jflags.set_flags(OFF)
        tflags.set_flags(OFF)
        _reset_all()


@pytest.mark.parametrize("capacity", [3, 8, 100])
def test_recorder_ring_equals_jax(capacity):
    def record(trace):
        clk = _FakeClock(1.0)
        rec = trace.TraceRecorder(capacity=capacity, clock=clk, rank=1)
        for i in range(6):
            with rec.span("outer", step=i):
                clk.advance(0.25)
                with rec.span("inner"):
                    clk.advance(0.5)
                rec.event("tick", i=i)
            rec.barrier("sync")
        rec.set_capacity(max(capacity // 2, 1))
        rec.event("late")
        return rec.events(), rec.dropped(), rec.capacity()

    assert record(ttrace) == record(jtrace)


def _two_ranks(skew=100.0):
    clk = {0: _FakeClock(0.0), 1: _FakeClock(skew)}
    per_rank = {}
    for r in (0, 1):
        rec = jtrace.TraceRecorder(clock=clk[r], rank=r)
        rec.event("boot")
        clk[r].advance(1.0 + r)
        rec.barrier("step0")
        clk[r].advance(0.5)
        with rec.span("work", step=0):
            clk[r].advance(0.25 * (r + 1))
        per_rank[r] = rec.events()
    return per_rank


def test_sidecar_merge_and_chrome_equal_jax(tmp_path):
    per_rank = _two_ranks()
    assert ttrace.merge_ranks(per_rank) == jtrace.merge_ranks(per_rank)
    paths = []
    for r, evs in per_rank.items():
        p = ttrace.write_sidecar(str(tmp_path / f"trace_rank{r}.jsonl"),
                                 evs, rank=r)
        jheader, jevs = jtrace.read_sidecar(p)
        theader, tevs = ttrace.read_sidecar(p)
        assert (jheader, jevs) == (theader, tevs)
        assert theader["schema"] == jtrace.SCHEMA and theader["rank"] == r
        paths.append(p)
    assert ttrace.merge_sidecars(paths) == jtrace.merge_sidecars(paths)
    merged = ttrace.merge_sidecars(paths)
    assert ttrace.chrome_events(merged) == jtrace.chrome_events(merged)
    ch = ttrace.chrome_events(merged)
    assert {e["ph"] for e in ch} == {"X", "i"}
    assert ttrace.sidecar_path(str(tmp_path), rank=3) == \
        jtrace.sidecar_path(str(tmp_path), rank=3)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "other"}\n')
    with pytest.raises(ValueError):
        ttrace.read_sidecar(str(bad))


def test_port_sidecar_reads_in_the_reference_and_trace_report(model, obs,
                                                              tmp_path):
    """A sidecar of a port engine's run: the reference reads it back
    event for event, ``tools/trace_report.py`` exits 0 with one terminal
    event a request, and its per-request TTFT (queue + prefill) is the
    engine's own TTFT on the engine clock."""
    cfg, _, tparams = model
    clk = _FakeClock(50.0)
    ttrace.set_clock(clk)
    eng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu",
                             clock=clk, **dict(KW, max_running=2))
    rids = [eng.add_request(p, 4) for p in _prompts(5)]
    while eng.has_work():
        clk.advance(0.01)
        eng.step()
    path = ttrace.write_sidecar(ttrace.sidecar_path(str(tmp_path)),
                                extra={"bench": "test"})
    header, evs = jtrace.read_sidecar(path)
    assert header["schema"] == jtrace.SCHEMA and header["bench"] == "test"
    assert evs == json.loads(json.dumps(ttrace.events()))
    assert jtrace.chrome_events(evs) == ttrace.chrome_events(evs)
    proc = subprocess.run([sys.executable, TRACE_REPORT, str(tmp_path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert not report.get("errors") and report["n_events"] == len(evs)
    reqs = report["requests"]
    assert reqs["count"] == reqs["terminal"] == len(rids)
    for row in reqs["per_request"]:
        r = eng.request(row["rid"])
        assert row["terminal"] == "finish"
        assert row["ttft_s"] == pytest.approx(
            r.first_token_s - r.arrival_s, abs=1e-9)
        assert row["queue_s"] + row["prefill_s"] == pytest.approx(
            row["ttft_s"], abs=1e-12)
    bd = reqs["breakdown"]
    assert bd["queue_p95_s"] + bd["prefill_p95_s"] == pytest.approx(
        bd["ttft_p95_s"])


@pytest.mark.parametrize("default,env", [
    (False, "1"), (False, "TRUE"), (True, "no"), (0, "-1"), (120.0, "2.5"),
    ("auto", "off"), (7, None)])
def test_flag_registry_parses_the_environment_as_the_reference(
        monkeypatch, default, env):
    name = "FLAGS_torch_port_test_flag"
    if env is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, env)
    try:
        got = tflags.define_flag(name, default)
        assert got == jflags.define_flag(name, default)
        assert type(got) is type(default)
        tflags.set_flags({name: default})
        assert tflags.get_flags(name) == {name: default}
        assert tflags.flag(name) == default
    finally:
        tflags._REGISTRY.pop(name, None)
        jflags._REGISTRY.pop(name, None)
    with pytest.raises(KeyError):
        tflags.set_flags({name: default})
    for f in ("FLAGS_tpu_metrics", "FLAGS_tpu_metrics_port",
              "FLAGS_tpu_trace", "FLAGS_tpu_watchdog",
              "FLAGS_tpu_watchdog_serve_step"):
        assert type(tflags._REGISTRY[f]) is type(jflags._REGISTRY[f])
