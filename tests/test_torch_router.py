"""The port's multi-replica router (``paddle_tpu_torch/serving/router.py``)
against the JAX router over two JAX engines, on the reference's router
cases (``tests/test_serving_resilience.py``, ``tests/test_trace.py``'s
per-replica cases, ``tests/test_serving_chaos_e2e.py``'s replica kill).

Over the same weights, prompts and injected faults both routers must
make the same decisions, exactly: the placements (gid -> replica, by
load and by prefix locality), the streams, the failovers and
migrations, the replica states, the per-replica tallies and their
metric series, and the autoscaler's drains.  A killed replica's streams
fail over and finish equal, token for token, to one uninterrupted
engine's, each token delivered once.  A replica step that blows the
router's ``step_timeout_s`` (``run_with_deadline``) kills the replica,
and the step it abandoned delivers nothing when it ends later.  The JAX
side runs its Pallas kernels in interpret mode.
"""
import signal
import threading

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
from paddle_tpu.runtime.health import HeartbeatTracker as JTracker
from paddle_tpu.serving import autoscale as jauto
from paddle_tpu.serving import router as jrouter
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import trace as ttrace
from paddle_tpu_torch.runtime import watchdog as twdog
from paddle_tpu_torch.runtime.health import HeartbeatTracker as TTracker
from paddle_tpu_torch.serving import autoscale as tauto
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.testing import chaos as tchaos

OBS = {"FLAGS_tpu_metrics": True, "FLAGS_tpu_trace": True}
OFF = {"FLAGS_tpu_metrics": False, "FLAGS_tpu_trace": False}


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _reset():
    for serving, router, auto in ((jserving, jrouter, jauto),
                                  (tserving, trouter, tauto)):
        serving.reset_stats()
        router.reset_replica_stats()
        auto.reset_fleet_stats()
    for mod in (jmetrics, tmetrics):
        mod.reset()
    for mod in (jtrace, ttrace):
        mod.clear()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    jflags.set_flags(OFF)
    tflags.set_flags(OFF)
    _reset()


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


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


N_NEW = 6


def _engine(side, model, **kw):
    cfg, params, tparams = model
    kw.setdefault("max_running", 4)
    kw.setdefault("chunk", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_model_len", 32)
    if side == "jax":
        return jserving.LLMEngine(cfg, params, donate_pools=False, **kw)
    return tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu", **kw)


def _pkg(side):
    return ((jserving, jrouter, jchaos) if side == "jax"
            else (tserving, trouter, tchaos))


def _pair(side, model, names=("a", "b"), engine_kw=None, **kw):
    serving = _pkg(side)[0]
    kw.setdefault("heartbeat_timeout", 1e6)
    engines = [(n, _engine(side, model, **(engine_kw or {})))
               for n in names]
    return serving.Router(engines, **kw), dict(engines)


@pytest.fixture(scope="module")
def expect(model):
    """One uninterrupted port engine's streams (equal to one JAX
    engine's: ``tests/test_torch_serving.py``)."""
    eng = _engine("port", model)
    rids = [eng.add_request(p, N_NEW) for p in _prompts(8, seed=7)]
    eng.run()
    return [eng.output_of(r) for r in rids]


def _placements(router, gids):
    return [router._requests[g].replica for g in gids]


def test_router_places_by_load_and_locality(model):
    def run(side):
        router, _ = _pair(side, model)
        g1 = router.submit([1, 2, 3, 4], 2)
        g2 = router.submit([9, 8, 7, 6], 2)
        g3 = router.submit([1, 2, 3, 4], 2)
        out = router.run(max_steps=200)
        gids = [g1, g2, g3]
        return (_placements(router, gids), [out[g] for g in gids],
                [router.is_finished(g) for g in gids])

    got = run("port")
    assert got == run("jax")
    places = got[0]
    assert set(places[:2]) == {"a", "b"} and places[2] == places[0]
    assert all(got[2])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kill_one_of_two_replicas_fails_over_as_the_reference(
        model, expect, kv_dtype):
    """The chaos e2e case in-process: kill replica r0 at its 3rd router
    step with half the streams mid-decode.  Every stream fails over and
    finishes; each token reaches the callback once; both routers agree
    on everything; over float pages the streams equal one uninterrupted
    engine's."""
    prompts = _prompts(8, seed=7)

    def run(side):
        serving, router_mod, chaos = _pkg(side)
        router, _ = _pair(side, model, names=("r0", "r1"),
                          engine_kw={"kv_dtype": kv_dtype})
        streamed = {}

        def on_tok(gid, tok, done):
            streamed.setdefault(gid, []).append(tok)

        gids = [router.submit(p, N_NEW, on_token=on_tok) for p in prompts]
        with chaos.installed(chaos.Chaos("kill@serve.replica.r0.step:step=3")):
            out = router.run(max_steps=1000)
        stats = serving.serving_stats()
        return {"out": [out[g] for g in gids],
                "streamed": [streamed.get(g, []) for g in gids],
                "states": router.replica_states(),
                "failovers": stats["failovers"],
                "replicas_dead": stats["replicas_dead"],
                "migrations": [router._requests[g].migrations for g in gids],
                "replica_stats": dict(router_mod._REPLICA_STATS)}

    got = run("port")
    assert got == run("jax")
    assert got["states"] == {"r0": "dead", "r1": "live"}
    assert got["replicas_dead"] == 1
    assert got["failovers"] >= 1 and sum(got["migrations"]) >= 1
    for out, streamed in zip(got["out"], got["streamed"]):
        assert streamed == out and len(out) == N_NEW
    if kv_dtype is None:
        assert got["out"] == expect


def test_drain_migrates_and_stops_placement(model, expect):
    prompts = _prompts(8, seed=7)

    def run(side):
        router, engines = _pair(side, model)
        gids = [router.submit(p, N_NEW) for p in prompts[:4]]
        router.step()
        moved = router.drain("a")
        state = router.replica_states()["a"]
        g_new = router.submit(prompts[4], N_NEW)
        a_idle = not engines["a"].has_work()
        out = router.run(max_steps=500)
        gids.append(g_new)
        return (moved, state, router._requests[g_new].replica, a_idle,
                [out[g] for g in gids], _placements(router, gids),
                _pkg(side)[0].serving_stats()["drains"])

    got = run("port")
    assert got == run("jax")
    moved, state, new_on, a_idle, outs, _, drains = got
    assert state == "draining" and new_on == "b" and a_idle
    assert moved >= 1 and drains == 1
    assert outs == expect[:5]


def test_sigterm_drains(model, expect):
    prompts = _prompts(8, seed=7)
    router, _ = _pair("port", model)
    gids = [router.submit(p, N_NEW) for p in prompts[:3]]
    prev = signal.getsignal(signal.SIGTERM)
    try:
        router.install_sigterm_drain("a")
        signal.raise_signal(signal.SIGTERM)
        assert router.replica_states()["a"] == "draining"
        out = router.run(max_steps=500)
        assert [out[g] for g in gids] == expect[:3]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_heartbeat_staleness_marks_dead(model):
    def run(side):
        clk = _FakeClock()
        router, _ = _pair(side, model, clock=clk, heartbeat_timeout=5.0)
        gid = router.submit([1, 2, 3], 4)
        victim = router._requests[gid].replica
        other = "b" if victim == "a" else "a"
        seen = [router.check_health()]
        clk.advance(3.0)
        router.observe_beat(other)
        seen.append(router.check_health())
        clk.advance(3.0)
        seen.append(router.check_health())
        moved_to = router._requests[gid].replica
        router.run(max_steps=200)
        return (victim, seen, router.replica_states(), moved_to,
                router.output_of(gid), router.is_finished(gid))

    got = run("port")
    assert got == run("jax")
    victim, seen, states, moved_to, _, finished = got
    assert seen == [[], [], [victim]] and states[victim] == "dead"
    assert moved_to != victim and finished


def test_no_live_replica_is_typed(model):
    router, _ = _pair("port", model)
    router._mark_dead("a", reason="test")
    router._mark_dead("b", reason="test")
    with pytest.raises(tserving.ReplicaUnavailable) as ei:
        router.submit([1, 2, 3], 2)
    assert ei.value.retriable


def test_all_replicas_shedding_propagates_rejection(model):
    def run(side):
        serving = _pkg(side)[0]
        router, _ = _pair(side, model,
                          engine_kw=dict(max_running=1, max_queue=1))
        placed = []
        with pytest.raises(serving.AdmissionRejected) as ei:
            for _ in range(10):
                placed.append(router.submit([1, 2, 3], 2))
        assert ei.value.retriable
        return len(placed), _pkg(side)[1]._REPLICA_STATS

    assert run("port") == run("jax")


def test_heartbeat_tracker_observer_clock_rule():
    def run(cls):
        clk = _FakeClock()
        t = cls(2.0, clock=clk)
        out = [t.observe("r", 0)]
        clk.advance(1.5)
        out += [t.observe("r", 0), t.is_stale("r"), t.observe("r", 1)]
        clk.advance(2.5)
        out += [t.observe("r", 1), t.is_stale("r"), t.stale(),
                t.silent_for("r")]
        t.forget("r")
        return out + [t.stale(), t.silent_for("r")]

    got = run(TTracker)
    assert got == run(JTracker)
    assert got == [0.0, 1.5, False, 0.0, 2.5, True, ["r"], 2.5, [], 0.0]


def _observed_run(side, model):
    """Placements and a dead replica under metrics and trace."""
    serving, router_mod, _ = _pkg(side)
    (jflags if side == "jax" else tflags).set_flags(OBS)
    metrics = jmetrics if side == "jax" else tmetrics
    trace = jtrace if side == "jax" else ttrace
    clk = _FakeClock()
    router, _ = _pair(side, model, clock=clk, heartbeat_timeout=5.0)
    gids = [router.submit([1, 2, 3], 3) for _ in range(4)]
    router.step()
    router.check_health()
    clk.advance(3.0)
    router.observe_beat("b")
    clk.advance(3.0)
    dead = router.check_health()
    router.run(max_steps=500)
    summary = [ln for ln in serving.summary_lines() if "replica" in ln]
    names = [e["name"] for e in trace.events() if e["name"].startswith(
        "route/")]
    series = {k: v for k, v in metrics.snapshot().items()
              if k.startswith(("serve_router", "serve_failovers",
                               "serve_replica", "health_incidents"))}
    return (dead, _placements(router, gids), dict(router_mod._REPLICA_STATS),
            summary, names, series, [router.output_of(g) for g in gids])


def test_per_replica_tallies_metrics_and_events_equal_the_reference(model):
    want = _observed_run("jax", model)
    got = _observed_run("port", model)
    assert got == want
    dead, _, stats, summary, names, series, _ = got
    assert dead == ["a"] and stats["a"]["dead"] == 1
    assert sum(s["placed"] for s in stats.values()) == 4 + stats["a"][
        "failovers"]
    assert any("replica a:" in ln for ln in summary)
    assert "route/place" in names and "route/replica_dead" in names
    assert "route/failover" in names
    assert any(k.startswith("serve_failovers_total{") and 'replica="a"' in k
               for k in series)


def test_autoscaler_scale_down_drains_as_the_reference(model):
    def run(side):
        auto = jauto if side == "jax" else tauto
        clk = _FakeClock()
        sm = auto.ServiceModel(max_running=4, chunk=4, page_size=8,
                               num_pages=17, max_model_len=32, max_queue=32,
                               prefill_chunk_s=0.01, decode_step_s=0.005)
        pol = auto.AutoscalePolicy(sm, slo_ttft_s=1.0, cooldown_s=0.05,
                                   windows_s=(1.0, 4.0), clock=clk)
        router, _ = _pair(side, model, names=("a", "b", "c"), clock=clk,
                          autoscaler=pol, autoscale_apply=True)
        gids = [router.submit(p, 4) for p in _prompts(4)]
        actions = []
        while router.has_work():
            clk.advance(0.02)
            router.step()
            actions.append(router.last_recommendation.to_dict())
        return (actions, router.replica_states(),
                [router.output_of(g) for g in gids], auto.fleet_stats())

    got = run("port")
    assert got == run("jax")
    actions, states, outs, fleet = got
    assert "draining" in states.values()
    assert fleet["applied"] >= 1 and all(len(o) == 4 for o in outs)


def test_add_replica_takes_new_placements(model):
    router, _ = _pair("port", model, names=("a",))
    g1 = router.submit([1, 2, 3], 2)
    router.add_replica("b", _engine("port", model))
    with pytest.raises(ValueError):
        router.add_replica("b", _engine("port", model))
    g2 = router.submit([5, 6, 7], 2)
    assert _placements(router, [g1, g2]) == ["a", "b"]
    router.run(max_steps=100)
    assert router.is_finished(g1) and router.is_finished(g2)


def test_step_timeout_kills_the_replica_and_its_late_step_delivers_nothing(
        model, expect, monkeypatch):
    """A replica step that hangs past ``step_timeout_s``: the router's
    ``run_with_deadline`` raises ``PhaseTimeout``, the replica is marked
    dead and its streams finish on the survivor, equal to the
    uninterrupted ones.  When the abandoned step ends afterwards it
    streams nothing more: every token was delivered once."""
    prompts = _prompts(8, seed=7)
    release = threading.Event()
    monkeypatch.setattr(tchaos, "_SLEEP", lambda s: release.wait(30))
    twdog.clear_incidents()
    router, engines = _pair("port", model, step_timeout_s=0.5)
    streamed = {}

    def on_tok(gid, tok, done):
        streamed.setdefault(gid, []).append(tok)

    gids = [router.submit(p, N_NEW, on_token=on_tok) for p in prompts]
    try:
        with tchaos.installed(
                tchaos.Chaos("hang@serve.step:step=3,times=1,secs=1")):
            out = router.run(max_steps=1000)
    finally:
        release.set()
    worker = [t for t in threading.enumerate()
              if t.name == "ptq-deadline-serve.replica.a"]
    for t in worker:
        t.join(timeout=30)
        assert not t.is_alive()
    assert router.replica_states() == {"a": "dead", "b": "live"}
    assert [out[g] for g in gids] == expect
    assert [streamed[g] for g in gids] == expect
    assert [router.output_of(g) for g in gids] == expect
    rec = [r for r in twdog.incidents() if r["kind"] == "watchdog_expired"]
    assert rec and rec[-1]["phase"] == "serve.replica.a"
    assert tserving.serving_stats()["replicas_dead"] == 1
    twdog.clear_incidents()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_run_with_deadline_as_the_reference(side):
    from paddle_tpu.runtime import watchdog as jwdog
    wdog = twdog if side == "port" else jwdog
    flags, metrics = ((tflags, tmetrics) if side == "port"
                      else (jflags, jmetrics))
    flags.set_flags({"FLAGS_tpu_metrics": True})
    wdog.clear_incidents()
    assert wdog.run_with_deadline(lambda: 5, 5.0, phase="p") == 5
    with pytest.raises(KeyError):
        wdog.run_with_deadline(lambda: {}["x"], 5.0, phase="p")
    release = threading.Event()
    with pytest.raises(wdog.PhaseTimeout) as ei:
        wdog.run_with_deadline(lambda: release.wait(30), 0.05,
                               phase="serve.replica.x", dump=False)
    release.set()
    assert ei.value.phase == "serve.replica.x"
    (rec,) = wdog.incidents()
    assert {k: rec[k] for k in ("kind", "phase", "deadline_s", "detail")} \
        == {"kind": "watchdog_expired", "phase": "serve.replica.x",
            "deadline_s": 0.05, "detail": "run_with_deadline"}
    snap = metrics.snapshot()
    assert snap['watchdog_expired_total{phase="serve.replica.x"}'] == 1.0
    assert snap['health_incidents_total{kind="watchdog_expired"}'] == 1.0
    wdog.clear_incidents()
