"""The port's fleet planning (``paddle_tpu_torch/serving/autoscale.py``)
against the reference's, on the reference's fleet cases
(``tests/test_fleet_sim.py``): the admission gate's hysteresis, the
``ServiceModel`` capacity arithmetic and its calibration from step
medians, ``replicas_for`` and ``recommend_fleet`` over each package's
own workloads, the burn-rate gauge and arrival forecast on explicit
time, and every ``AutoscalePolicy`` decision over the same sequences,
exactly.  Then ``service_model()`` of the JAX engine and of the port's
engine, run under the same fake clock with the same injected step
stalls, equal field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import pallas_ops
from paddle_tpu.serving import AdmissionGate as JGate
from paddle_tpu.serving import autoscale as jauto
from paddle_tpu.serving import workloads as jwork
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import AdmissionGate as TGate
from paddle_tpu_torch.serving import autoscale as tauto
from paddle_tpu_torch.serving import workloads as twork
from paddle_tpu_torch.testing import chaos as tchaos

SIDES = {"jax": (jauto, jwork), "port": (tauto, twork)}


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _both(fn):
    """Run ``fn(autoscale, workloads)`` on both packages; the port's
    result must equal the reference's.  Returns it."""
    want = fn(*SIDES["jax"])
    got = fn(*SIDES["port"])
    assert got == want
    return got


def _model(auto, **kw):
    kw.setdefault("max_running", 8)
    kw.setdefault("chunk", 16)
    kw.setdefault("page_size", 16)
    kw.setdefault("num_pages", 33)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_queue", 64)
    return auto.ServiceModel(**kw)


def test_admission_gate_watermark_hysteresis():
    def run(gate_cls):
        g = gate_cls(8)
        return g.recover_below, [g.check(d) for d in
                                 (0, 7, 8, 5, 4, 7, 9, 3, 8)]

    got = run(TGate)
    assert got == run(JGate)
    assert got == (4, [False, False, True, True, False, False, True,
                       False, True])


def test_service_model_capacity_arithmetic():
    def run(auto, _w):
        m = _model(auto)
        pool_bound = dataclasses.replace(m, num_pages=9)
        return (m.to_dict(), pool_bound.to_dict(),
                m.steps_per_request(32, 8), m.request_service_s(32, 8),
                m.capacity_rps(32, 8), pool_bound.capacity_rps(32, 8),
                m.mean_step_s(32, 8))

    d, pd, steps, svc, cap, pcap, mean = _both(run)
    assert d["blocks_per_request"] == 4
    assert d["concurrency"] == 8 and pd["concurrency"] == 2
    assert steps == 2 + 7
    assert svc == pytest.approx(2 * d["prefill_chunk_s"]
                                + 7 * d["decode_step_s"])
    assert cap > pcap
    assert d["decode_step_s"] < mean < d["prefill_chunk_s"]


def test_service_model_calibrates_from_step_medians():
    def run(auto, _w):
        kw = dict(max_running=8, chunk=16, page_size=16, num_pages=33,
                  max_model_len=64, max_queue=64)
        m = auto.ServiceModel.from_step_samples(
            {1: [0.01, 0.02, 0.03], 16: [0.05, 0.07, 0.50]}, **kw)
        m0 = auto.ServiceModel.from_step_samples({}, **kw)
        mb = auto.ServiceModel.from_breakdown(
            {"prefill_mean_s": 0.09, "decode_mean_s": 0.21},
            prompt_len=40, new_tokens=8, **kw)
        return (m.to_dict(), m0.to_dict(), mb.to_dict(),
                (auto.DEFAULT_PREFILL_CHUNK_S, auto.DEFAULT_DECODE_STEP_S))

    m, m0, mb, defaults = _both(run)
    assert m["calibrated"] and m["decode_step_s"] == pytest.approx(0.02)
    assert m["prefill_chunk_s"] == pytest.approx(0.07)
    assert not m0["calibrated"]
    assert (m0["prefill_chunk_s"], m0["decode_step_s"]) == defaults == (
        0.02, 0.005)
    assert mb["calibrated"] and mb["prefill_chunk_s"] == pytest.approx(0.03)


@pytest.mark.parametrize("frac", [0.0, 0.8, 1.7, 5.3])
def test_replicas_for_applies_headroom(frac):
    def run(auto, _w):
        m = _model(auto)
        cap = m.capacity_rps(32, 8)
        return [auto.replicas_for(m, cap * frac, prompt_len=32,
                                  new_tokens=8, headroom=h)
                for h in (0.85, 0.5, 1.0)]

    got = _both(run)
    assert got[0] == {0.0: 1, 0.8: 1, 1.7: 2, 5.3: 7}[frac]


@pytest.mark.parametrize("preset", ["flash-crowd", "diurnal", "bursty"])
def test_recommend_fleet_sizes_to_peak_not_mean(preset):
    def run(auto, work):
        m = _model(auto, num_pages=9, max_running=2, prefill_chunk_s=0.05,
                   decode_step_s=0.02)
        arr = work.generate(preset, 300, seed=0, horizon_s=60.0,
                            prompt_len=12, max_new_tokens=8)
        rec = auto.recommend_fleet(m, arr)
        by_mean = auto.replicas_for(
            m, rec["offered_rps_mean"], prompt_len=rec["prompt_len"],
            new_tokens=rec["new_tokens"])
        return rec, by_mean, auto.recommend_fleet(m, [])

    rec, by_mean, empty = _both(run)
    assert rec["offered_rps_peak"] >= rec["offered_rps_mean"]
    assert rec["min_replicas"] >= by_mean
    assert empty["min_replicas"] == 1
    if preset == "flash-crowd":
        assert rec["min_replicas"] > by_mean


def test_burn_gauge_multi_window_math():
    def run(auto, _w):
        g = auto.SLOBurnGauge(windows_s=(10.0, 40.0), budget=0.05)
        out = [g.burn_rates(0.0)]
        for t in range(10):
            g.observe(ok=(t >= 2), t=float(t))
        out += [g.burn_rates(9.0), g.burn_rates(15.0), g.burn_rates(60.0)]
        return out

    got = _both(run)
    assert got[0] == {10.0: None, 40.0: None}
    assert got[1][10.0] == pytest.approx(4.0)
    assert got[2][10.0] == 0.0 and got[2][40.0] == pytest.approx(4.0)


def test_arrival_forecast_tracks_decays_and_projects():
    def run(auto, _w):
        f = auto.ArrivalForecast(tau_s=2.0)
        t = 0.0
        for _ in range(50):
            t += 0.1
            f.observe(t)
        steady = (f.rate(t), f.rate(t + 10.0), f.forecast(t, 5.0))
        g = auto.ArrivalForecast(tau_s=2.0)
        t, dt = 0.0, 0.5
        for _ in range(60):
            dt *= 0.93
            t += dt
            g.observe(t)
        return steady, (g.rate(t), g.forecast(t, horizon_s=5.0))

    (rate, decayed, _), (rate2, fc2) = _both(run)
    assert 5.0 <= rate <= 15.0 and decayed < 1.0
    assert fc2 > rate2


def _policy(auto, m, **kw):
    kw.setdefault("slo_ttft_s", 0.2)
    kw.setdefault("prompt_len", 32)
    kw.setdefault("new_tokens", 8)
    kw.setdefault("windows_s", (5.0, 20.0))
    kw.setdefault("horizon_s", 10.0)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("forecast_tau_s", 2.0)
    kw.setdefault("clock", lambda: 0.0)
    return auto.AutoscalePolicy(m, **kw)


def _forecast_up(auto, _w):
    m = _model(auto, max_running=2, num_pages=9, prefill_chunk_s=0.05,
               decode_step_s=0.02)
    pol = _policy(auto, m)
    t = 0.0
    for _ in range(100):
        t += 0.05
        pol.observe_arrival(t=t)
    return [pol.recommend(1, t=t).to_dict()]


def _burn_up(auto, _w):
    pol = _policy(auto, _model(auto))
    t, recs = 0.0, []
    for _ in range(20):
        t += 1.0
        pol.observe_arrival(t=t)
        pol.observe_ttft(10.0, t=t)
        recs.append(pol.recommend(2, t=t).to_dict())
    return recs


def _scale_down(auto, _w):
    pol = _policy(auto, _model(auto), cooldown_s=10.0)
    pol.observe_arrival(t=0.0)
    pol.observe_arrival(t=0.1)
    recs = [pol.recommend(4, t=t) for t in (50.0, 55.0, 61.0)]
    pol.mark_applied(recs[-1])
    return [r.to_dict() for r in recs]


@pytest.mark.parametrize("case", [_forecast_up, _burn_up, _scale_down],
                         ids=["forecast_up", "burn_up", "scale_down"])
def test_policy_decisions_equal_the_reference(case):
    recs = _both(case)
    if case is _forecast_up:
        (rec,) = recs
        assert rec["action"] == "scale_up" and rec["target_replicas"] > 1
        assert all(b is None for b in rec["burn"].values())
    elif case is _burn_up:
        ups = [r for r in recs if r["action"] == "scale_up"]
        assert ups and ups[0]["target_replicas"] == 3
        assert "burn" in ups[0]["reason"]
        # the reactive bump is paced: one per fast window at most
        assert len(ups) < len(recs)
    else:
        assert [r["action"] for r in recs] == ["hold", "hold",
                                               "scale_down"]
        assert recs[-1]["applied"] and recs[-1]["target_replicas"] < 4


def test_fleet_stats_and_summary_lines_equal_the_reference():
    def run(auto, _w):
        auto.reset_fleet_stats()
        empty = auto.fleet_summary_lines()
        pol = _policy(auto, _model(auto))
        pol.observe_arrival(t=0.0)
        pol.observe_ttft(10.0, t=0.1)
        pol.recommend(1, t=1.0)
        out = auto.fleet_stats(), empty, auto.fleet_summary_lines()
        auto.reset_fleet_stats()
        return out

    stats, empty, lines = _both(run)
    assert empty == ["Fleet", "  (no AutoscalePolicy instantiated)"]
    assert stats["policies"] == 1 and stats["ttft_violations"] == 1
    assert any("recommendations: 1" in ln for ln in lines)


# ---------------------------------------------------------------------------
# service_model() of both engines under one fake clock
# ---------------------------------------------------------------------------

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


# the step stalls (every matching rule fires: step 0 stalls 0.044 s, step
# 1 0.034, step 3 0.013, the others 0.004); steps 0-1 are prefill steps
# (Tc = 4), the rest decode
STALLS = ("stall@serve.step:step=0,secs=0.040;"
          "stall@serve.step:step=1,secs=0.030;"
          "stall@serve.step:step=3,secs=0.009;"
          "stall@serve.step:secs=0.004")


def _service_model(side, monkeypatch):
    cfg = _jax_cfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    clk = _FakeClock(5.0)
    kw = dict(max_running=4, chunk=4, page_size=8, max_model_len=32,
              clock=clk)
    if side == "jax":
        eng = jserving.LLMEngine(cfg, params, donate_pools=False, **kw)
        chaos = jchaos
    else:
        tparams = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), device="cpu")
        eng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu",
                                 **kw)
        chaos = tchaos
    monkeypatch.setattr(chaos, "_SLEEP", clk.advance)
    rng = np.random.RandomState(3)
    for _ in range(4):
        eng.add_request([int(t) for t in rng.randint(0, 128, 6)], 6)
    with chaos.installed(chaos.Chaos(STALLS)):
        while eng.has_work():
            clk.advance(0.01)
            eng.step()
    return eng.service_model(), {k: list(v)
                                 for k, v in eng._step_wall_s.items()}


def test_engine_service_models_equal_under_a_fake_clock(monkeypatch):
    want, jwall = _service_model("jax", monkeypatch)
    got, twall = _service_model("port", monkeypatch)
    assert twall == jwall
    assert got.to_dict() == want.to_dict()
    assert got.calibrated
    assert got.prefill_chunk_s == pytest.approx(0.039)
    assert got.decode_step_s == pytest.approx(0.004)
    rate = 3 * got.capacity_rps(6, 6)
    assert tauto.replicas_for(got, rate, prompt_len=6, new_tokens=6) == \
        jauto.replicas_for(want, rate, prompt_len=6, new_tokens=6) >= 3
