"""The port's crash recovery, deadlines and SLO report against the JAX
reference engine, and its watchdog and chaos harness against the
reference's.

Under the same injected faults both engines must leave the same
streams, token for token: a transient ``fail@serve.step`` with the
prefix cache and a self-draft on (one recovery, pools rebuilt, every
request replayed), a ``rid=``-scoped poison (bisection quarantines the
same request with the same probes), a hang past the ``serve.step``
deadline (replayed without probes; the port's on an injected fake
clock), and a chaos ``exhaust`` under a populated prefix trie.
Deadlines fail a request with a typed ``DeadlineExceeded``, and the SLO
report equals JAX's on the same fake clock.  The JAX side runs its
Pallas kernels in interpret mode.
"""
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import pallas_ops
from paddle_tpu.runtime import watchdog as jwdog
from paddle_tpu.serving.kv_cache import BlockAllocator as JAllocator
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.runtime import watchdog as twdog
from paddle_tpu_torch.serving.kv_cache import BlockAllocator
from paddle_tpu_torch.testing import chaos as tchaos


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


def _prompts():
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, 128, rng.randint(3, 10))]
            for _ in range(6)]


def _shared_prompts():
    rng = np.random.RandomState(5)
    sys_a = [int(t) for t in rng.randint(1, 127, 13)]
    sys_b = [int(t) for t in rng.randint(1, 127, 9)]
    return [(sys_a if i % 2 == 0 else sys_b)
            + [int(t) for t in rng.randint(1, 127, 3 + i % 3)]
            for i in range(4)]


def _engines(model, spec=False, jax_kw=None, port_kw=None, **kw):
    """A JAX engine and a port engine over the same weights."""
    cfg, params, tparams = model
    tcfg = _port_cfg(cfg)
    jkw, tkw = dict(kw, **(jax_kw or {})), dict(kw, **(port_kw or {}))
    if spec:
        jkw["spec"] = jserving.SpecDecodeConfig(cfg=cfg, params=params, k=3)
        tkw["spec"] = tserving.SpecDecodeConfig(tcfg, tparams, k=3)
    jeng = jserving.LLMEngine(cfg, params, donate_pools=False, **jkw)
    teng = tserving.LLMEngine(tcfg, tparams, device="cpu", **tkw)
    return jeng, teng


def _drive(eng, prompts, n_new, **add):
    rids = [eng.add_request(list(p), n_new, **add) for p in prompts]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 2000, "engine did not converge"
    return rids


def _probes(eng):
    """Record the size of every bisection probe the engine runs."""
    sizes = []
    orig = eng._probe

    def probe(group):
        sizes.append(len(group))
        return orig(group)

    eng._probe = probe
    return sizes


KW = dict(max_running=4, chunk=4, page_size=8, max_model_len=32)


def test_transient_failure_with_prefix_and_spec_replays_identically(model):
    """fail@serve.step:step=2 once, prefix cache and self-draft on: one
    recovery, the trie and both pools rebuilt, every stream replayed
    bit-identical to the JAX engine's (and to an unfaulted run)."""
    prompts, n_new = _shared_prompts(), 8
    kw = dict(max_running=4, chunk=8, page_size=4, num_pages=200,
              prefix_cache=True)
    out = {}
    for side, serving, chaos in (("jax", jserving, jchaos),
                                 ("port", tserving, tchaos)):
        jeng, teng = _engines(model, spec=True, **kw)
        eng = jeng if side == "jax" else teng
        serving.reset_stats()
        with chaos.installed(chaos.Chaos("fail@serve.step:step=2,times=1")):
            rids = _drive(eng, prompts, n_new)
        stats = serving.serving_stats()
        assert stats["recoveries"] == 1 and stats["quarantined"] == 0
        assert eng.kv.audit()["ok"]
        out[side] = ([eng.output_of(r) for r in rids], stats, eng)
    (j_out, j_stats, _), (t_out, t_stats, teng) = out["jax"], out["port"]
    assert t_out == j_out
    for key in ("spec_proposed", "spec_accepted", "prefix_hit_tokens",
                "steps", "decode_tokens", "prefill_tokens"):
        assert t_stats[key] == j_stats[key], key
    assert teng.forwards["probe"] == 1       # the transient did not repeat
    rec = twdog.last_incident()
    assert rec["kind"] == "serve_step_failure"
    assert rec["failure"] == "injected" and rec["culprit"] is None
    # the unfaulted port run streams the same
    _, teng2 = _engines(model, spec=True, **kw)
    rids = _drive(teng2, prompts, n_new)
    assert [teng2.output_of(r) for r in rids] == t_out


@pytest.mark.parametrize("poison", [0, 2, 5])
def test_rid_scoped_poison_quarantines_the_same_request(model, poison):
    prompts, n_new = _prompts(), 6
    res = {}
    for side, serving, chaos in (("jax", jserving, jchaos),
                                 ("port", tserving, tchaos)):
        jeng, teng = _engines(model, **KW)
        eng = jeng if side == "jax" else teng
        sizes = _probes(eng)
        rids = [eng.add_request(p, n_new) for p in prompts]
        serving.reset_stats()
        with chaos.installed(chaos.Chaos(
                f"fail@serve.step:rid={rids[poison]}")):
            while eng.has_work():
                eng.step()
        states = [eng.state_of(r).value for r in rids]
        res[side] = (states, [eng.output_of(r) for r in rids], sizes,
                     serving.serving_stats()["quarantined"],
                     type(eng.error_of(rids[poison])).__name__)
        assert eng.kv.allocator.num_allocated == 0
    assert res["port"] == res["jax"]
    states, _, sizes, quarantined, err = res["port"]
    assert states[poison] == "failed" and err == "RequestQuarantined"
    assert states.count("finished") == len(prompts) - 1
    assert quarantined == 1
    assert len(sizes) <= 1 + 2 * math.ceil(math.log2(KW["max_running"]))


def test_hang_past_the_deadline_replays_on_a_fake_clock(model, monkeypatch):
    """A bounded hang past the serve.step deadline: the port's watchdog
    and engine run on one injected clock that the hang advances (no
    real sleep); the late step is classified a hang, replayed without
    probes, and the streams equal the JAX engine's under a real hang."""
    prompts, n_new = _prompts()[:3], 6
    jwd = jwdog.Watchdog(deadlines={"serve.step": 0.01}, dump=False)
    jeng, _ = _engines(model, jax_kw=dict(watchdog=jwd), **KW)
    with jchaos.installed(
            jchaos.Chaos("hang@serve.step:step=1,times=1,secs=0.05")):
        jrids = _drive(jeng, prompts, n_new)

    clk = _FakeClock(50.0)
    monkeypatch.setattr(tchaos, "_SLEEP", clk.advance)
    twd = twdog.Watchdog(clock=clk, deadlines={"serve.step": 1.0},
                         dump=False)
    _, teng = _engines(model, port_kw=dict(watchdog=twd, clock=clk), **KW)
    twdog.clear_incidents()
    tserving.reset_stats()
    with tchaos.installed(
            tchaos.Chaos("hang@serve.step:step=1,times=1,secs=5")) as c:
        trids = _drive(teng, prompts, n_new)
    assert c.log == [("serve.step", 1, "hang")]
    assert clk() == 55.0
    assert ([teng.output_of(r) for r in trids]
            == [jeng.output_of(r) for r in jrids])
    kinds = [r["kind"] for r in twdog.incidents()]
    assert kinds == ["watchdog_expired", "serve_step_failure"]
    assert twdog.last_incident()["failure"] == "hang"
    assert twd.expired[0].elapsed_s == 5.0
    assert teng.forwards["probe"] == 0
    assert tserving.serving_stats()["recoveries"] == 1


def test_chaos_exhaust_under_a_populated_trie(model):
    """exhaust grabs only free pages (never a cached one), the starved
    engine self-preempts instead of crashing, and releasing chaos's
    tenant drops only its own references; the streams equal JAX's."""
    prompts, n_new = _shared_prompts()[:3], 8
    kw = dict(max_running=2, chunk=8, page_size=4, num_pages=40,
              prefix_cache=True)
    outs = []
    for side, chaos in (("jax", jchaos), ("port", tchaos)):
        jeng, teng = _engines(model, **kw)
        eng = jeng if side == "jax" else teng
        rids = [eng.add_request(list(p), n_new) for p in prompts]
        with chaos.installed(
                chaos.Chaos("exhaust@serve.step:step=2,times=1")) as c:
            for _ in range(6):
                eng.step()
            assert eng.has_work()
            cached = set(eng.kv.prefix.cached_pages())
            (alloc, pages), = c.rules[0].held_pages
            assert cached.isdisjoint(pages) and alloc is eng.kv.allocator
            c.release_exhausted()
            assert not c.rules[0].held_pages
            while eng.has_work():
                eng.step()
        assert eng.kv.audit()["ok"]
        outs.append([eng.output_of(r) for r in rids])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mod", [tchaos, jchaos], ids=["port", "jax"])
@pytest.mark.parametrize("alloc_cls", [BlockAllocator, JAllocator],
                         ids=["port_alloc", "jax_alloc"])
def test_release_exhausted_skips_recycled_pages(mod, alloc_cls):
    a = alloc_cls(8, 4)
    c = mod.Chaos("exhaust@pool.x")
    c.hit("pool.x", pool=a)
    (rule,) = c.rules
    _alloc, pages = rule.held_pages[0]
    a.decref(pages[:1])                  # recycled out from under chaos
    c.release_exhausted()                # must not raise
    assert a.num_allocated == 0 and a.num_free == 7


def test_deadline_expiry_is_typed_and_slo_sets_the_default(model):
    clk = _FakeClock()
    _, eng = _engines(model, port_kw=dict(clock=clk), **KW)
    fast = eng.add_request([1, 2, 3], 4, deadline_s=100.0)
    slow = eng.add_request([4, 5, 6], 4, deadline_s=0.5)
    tserving.reset_stats()
    eng.step()
    clk.advance(1.0)  # past slow's deadline, inside fast's
    while eng.has_work():
        eng.step()
    assert eng.state_of(fast) is tserving.RequestState.FINISHED
    assert eng.state_of(slow) is tserving.RequestState.FAILED
    err = eng.error_of(slow)
    assert isinstance(err, tserving.DeadlineExceeded) and not err.retriable
    assert "missed its deadline by 0.500s" in str(err)
    assert eng.error_of(fast) is None
    assert tserving.serving_stats()["deadline_expired"] == 1
    assert eng.kv.allocator.num_allocated == 0

    _, eng2 = _engines(model, port_kw=dict(
        clock=clk, slo=tserving.SLOConfig(deadline_s=2.0)), **KW)
    rid = eng2.add_request([1, 2, 3], 4)
    assert eng2.request(rid).deadline_s == clk() + 2.0
    rid2 = eng2.add_request([1, 2, 3], 4, deadline_s=7.0)
    assert eng2.request(rid2).deadline_s == clk() + 7.0


def test_slo_report_equals_jax_on_the_same_fake_clock(model):
    """Both engines on their own fake clock, advanced by the same
    amounts around the same steps: every field of slo_report equals."""
    prompts, n_new = _prompts(), 5
    slo = dict(ttft_p95_s=0.35, latency_p95_s=0.05)
    reports = []
    for side in ("jax", "port"):
        clk = _FakeClock(10.0)
        jeng, teng = _engines(
            model, jax_kw=dict(clock=clk, slo=jserving.SLOConfig(**slo)),
            port_kw=dict(clock=clk, slo=tserving.SLOConfig(**slo)), **KW)
        eng = jeng if side == "jax" else teng
        pending = list(prompts)
        steps = 0
        while pending or eng.has_work():
            if pending and steps % 2 == 0:
                eng.add_request(pending.pop(0), n_new)
            clk.advance(0.01 * (1 + steps % 3))
            eng.step()
            steps += 1
        reports.append(eng.slo_report())
    j, t = reports
    assert t.keys() == j.keys() and t["breakdown"].keys() == j[
        "breakdown"].keys()
    for key in ("ttft_slo_s", "latency_slo_s", "ttft_ok", "latency_ok"):
        assert t[key] == j[key], key
    for key in ("ttft_p95_s", "latency_p95_s"):
        assert t[key] == pytest.approx(j[key], rel=1e-12, abs=0), key
    for key, v in j["breakdown"].items():
        assert t["breakdown"][key] == pytest.approx(v, rel=1e-12,
                                                    abs=0), key
    assert t["ttft_ok"] is True and t["latency_ok"] is False
    assert t["breakdown"]["samples"] == len(prompts)


SPECS = ["fail@serve.step:step=2,times=1",
         "hang@serve.step:step=3,secs=2.5",
         "stall@serve.*:prob=0.25,after=2",
         "kill@serve.replica.a.step:step=3",
         "exhaust@serve.step:times=1",
         "raise@serve.step:rid=7;stall@x:sleep_s=0.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_grammar_parses_as_the_reference(spec):
    def key(c):
        return [(r.action, r.point, r.step, r.times, r.after, r.prob,
                 r.secs, r.rid) for r in c.rules]

    assert key(tchaos.Chaos(spec)) == key(jchaos.Chaos(spec))


@pytest.mark.parametrize("bad", ["fail", "fail@", "nope@serve.step",
                                 "fail@serve.step:step", "fail@x:size=3",
                                 "crash@ckpt.commit", "fail@x:rank=1"])
def test_chaos_grammar_rejects_what_it_does_not_parse(bad):
    # the port rejects what the reference rejects; the last two parse in
    # both (the crash action, the rank= option) and must parse alike
    try:
        ref = jchaos.Chaos(bad)
    except ValueError:
        ref = None
    if ref is None:
        with pytest.raises(ValueError):
            tchaos.Chaos(bad)
        return
    got = tchaos.Chaos(bad)
    assert ([(r.action, r.point, r.step, r.rank, r.restart, r.resize)
             for r in got.rules]
            == [(r.action, r.point, r.step, r.rank, r.restart, r.resize)
                for r in ref.rules])


def test_chaos_schedule_fires_as_the_reference():
    """Seeded prob, after, times, step and rid filters fire on the same
    hits in both harnesses."""
    spec = ("stall@serve.step:prob=0.5,secs=0;fail@serve.step:rid=3,"
            "after=1,times=2;kill@other:step=4")
    logs = []
    for mod in (jchaos, tchaos):
        c = mod.Chaos(spec, seed=7)
        log = []
        for step in range(12):
            for point, rids in (("serve.step", [1, 3] if step % 3 else [2]),
                                ("other", [])):
                try:
                    c.hit(point, step=step, rids=rids)
                    log.append("ok")
                except mod.ReplicaKilled:
                    log.append("killed")
                except mod.ChaosError:
                    log.append("failed")
        logs.append((log, c.log, [(r.hits, r.fired) for r in c.rules]))
    assert logs[0] == logs[1]
    assert "killed" in logs[1][0] and "failed" in logs[1][0]


def test_chaos_point_is_inert_without_a_schedule():
    assert tchaos.active() is None
    tchaos.chaos_point("serve.step", step=0, rids=[1])
    with tchaos.installed("fail@serve.step") as c:
        assert tchaos.active() is c
        with pytest.raises(tchaos.ChaosError):
            tchaos.chaos_point("serve.step", step=0)
    assert tchaos.active() is None


def test_watchdog_begin_end_poll_as_the_reference():
    traces = []
    for mod in (jwdog, twdog):
        clk = _FakeClock()
        fired = []
        wd = mod.Watchdog(clock=clk, deadlines={"serve.step": 2.0,
                                                 "other": 0},
                          on_expire=fired.append, dump=False)
        mod.clear_incidents()
        wd.begin("serve.step")
        wd.begin("other")
        clk.advance(1.5)
        a = wd.poll()
        clk.advance(1.0)
        b = wd.poll(raise_on_expire=False)
        c = wd.poll(raise_on_expire=False)       # expires only once
        elapsed = wd.end("serve.step")
        clk.advance(3.0)
        wd.begin("serve.step")
        clk.advance(2.5)
        with pytest.raises(mod.PhaseTimeout) as ei:
            wd.poll()
        with wd.phase("p", deadline_s=1.0):
            assert sorted(wd.active_phases()) == ["other", "p",
                                                  "serve.step"]
        assert wd.end("never-begun") == 0.0
        recs = [{k: r[k] for k in ("kind", "phase", "elapsed_s",
                                   "deadline_s")} for r in mod.incidents()]
        traces.append((a, [(e.phase, e.elapsed_s, e.deadline_s)
                           for e in b], c, elapsed, str(ei.value),
                       [(e.phase, e.elapsed_s) for e in fired],
                       [e.phase for e in wd.expired], recs,
                       wd.deadline_for("other")))
    assert traces[0] == traces[1]
    assert traces[1][1] == [("serve.step", 2.5, 2.0)]


def test_failure_classification_matches_reference():
    cases = [twdog.PhaseTimeout("serve.step", 2, 1),
             tchaos.ChaosError("x"), tchaos.ReplicaKilled("x"),
             RuntimeError("cuda"), torch.AcceleratorError("illegal address"),
             OSError("io"), ValueError("?"), FloatingPointError("nan")]
    want = ["hang", "injected", "injected", "device_error", "device_error",
            "device_error", "unknown", "non_finite"]
    assert [tserving.LLMEngine._classify(e) for e in cases] == want
    # the reference's kinds for the same failures (its non-finite error
    # is NonFiniteError, which the port's FloatingPointError stands for)
    from paddle_tpu.profiler.numerics import NonFiniteError
    jcases = [jwdog.PhaseTimeout("serve.step", 2, 1), jchaos.ChaosError("x"),
              jchaos.ReplicaKilled("x"), RuntimeError("cuda"),
              RuntimeError("illegal address"), OSError("io"),
              ValueError("?"), NonFiniteError("nan")]
    assert [jserving.LLMEngine._classify(e) for e in jcases] == want


def test_a_failure_inside_recovery_propagates(model, monkeypatch):
    """No loop and no fallback: when the rebuild's allocation fails (a
    CUDA error that left the context unusable), the step raises."""
    _, eng = _engines(model, **KW)
    eng.add_request([1, 2, 3], 4)

    def dead(*a, **k):
        raise torch.AcceleratorError("CUDA error: an illegal memory "
                                     "access was encountered")

    with tchaos.installed("fail@serve.step:times=1"):
        monkeypatch.setattr(eng, "_alloc_pools", dead)
        with pytest.raises(torch.AcceleratorError):
            eng.step()


def test_replica_kill_propagates(model):
    _, eng = _engines(model, **KW)
    eng.add_request([1, 2, 3], 4)
    tserving.reset_stats()
    with tchaos.installed("kill@serve.step:step=0"):
        with pytest.raises(tchaos.ReplicaKilled):
            eng.step()
    assert tserving.serving_stats()["recoveries"] == 0


def test_rebuild_frees_the_failed_pools_before_allocating(monkeypatch):
    """A step that fails inside the forward (non-finite logits): its
    traceback no longer holds the pools when the rebuild allocates, so
    recovery never holds two sets; each probe's scratch pools hold only
    the pages its group needs, never the live ones."""
    cfg = _port_cfg(_jax_cfg())
    params = tllama.init_params(cfg, 0, device="cpu")
    params["lm_head"][:, 5] = float("nan")
    eng = tserving.LLMEngine(cfg, params, device="cpu", max_model_len=32,
                             kv_dtype="int8", **{k: v for k, v in KW.items()
                                                 if k != "max_model_len"})
    for p in ([1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11]):
        eng.add_request(p, 2)
    old = [weakref.ref(t) for t in (eng._kp, eng._vp, eng._ks, eng._vs)]
    zeros, seen = torch.zeros, []

    def spy(shape, *a, **k):
        seen.append((tuple(shape), [r() is None for r in old]))
        return zeros(shape, *a, **k)

    monkeypatch.setattr(torch, "zeros", spy)
    assert eng.step() == []
    pools = [s for s in seen if s[0][:2] == eng._pool_shape[:2]
             and len(s[0]) == 5]
    # the rebuild's k and v pools, allocated after the old ones died
    assert pools[:2] == [(eng._pool_shape, [True] * 4)] * 2
    # then the probes (all 3 requests, then the first alone): 1 + the
    # pages of each group's first chunk (4 tokens, pages of 8: one each)
    L, nkv, _, page, d = eng._pool_shape
    assert [s[0] for s in pools[2:]] == [
        (L, nkv, 1 + n, page, d) for n in (3, 1) for _ in range(2)]
    first = next(iter(eng._requests))
    assert eng.state_of(first) is tserving.RequestState.FAILED
