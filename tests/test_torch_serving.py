"""The port's serving engine against the JAX reference engine.

Greedy streams must be equal token for token: 10 requests, 8 slots,
continuous admission (4 requests up front, the rest while the batch is in
flight) and forced preemption (10 pool pages, as in the reference's
preemption test), with dense and with int8 weights, over float32 and
over int8 KV pages.  Both engines get the same weights through
``params_from_jax`` and run in float32 on the CPU.  With int8 pages the
two sides may round a byte differently at a tie (their matmuls sum in
another order); on these workloads no stream moves.
The scheduler, page allocator and admission gate are the port's copies
and must keep the same books as the reference on the same script.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import scheduler as tsched


def _jax_cfg(quantized):
    return jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, dtype=jnp.float32, use_remat=False,
        quantized=quantized)


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


def _workload():
    rng = np.random.RandomState(7)
    prompts = [[int(t) for t in rng.randint(0, 128, rng.randint(3, 14))]
               for _ in range(10)]
    new_toks = [int(rng.randint(6, 13)) for _ in range(10)]
    return prompts, new_toks


def _serve(eng, prompts, new_toks):
    """Continuous admission: 4 requests, two steps, then the other 6
    arrive while the batch is in flight.  Returns (outputs, streams,
    steps)."""
    streams = {}

    def on_tok(rid, tok, fin):
        streams.setdefault(rid, []).append(int(tok))

    rids = [eng.add_request(prompts[i], new_toks[i], on_token=on_tok)
            for i in range(4)]
    eng.step()
    eng.step()
    rids += [eng.add_request(prompts[i], new_toks[i], on_token=on_tok)
             for i in range(4, 10)]
    steps = 2
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 2000, "engine did not converge"
    return ([eng.output_of(r) for r in rids],
            [streams.get(r, []) for r in rids], steps)


# 10 pool pages (9 usable): with 16-token pages all 8 slots fill and one
# request is preempted; with 8-token pages at most 6 run at once and
# preemption replays 8 times.  kv_dtype None = the model's (f32) pages.
@pytest.mark.parametrize("page_size,peak,kv_dtype", [
    pytest.param(16, 8, None, id="16-8"),
    pytest.param(8, 6, None, id="8-6"),
    pytest.param(16, 8, "int8", id="16-8-int8"),
    pytest.param(8, 6, "int8", id="8-6-int8")])
@pytest.mark.parametrize("quantized", ["off", "on"])
def test_streams_match_jax_engine_under_preemption(quantized, page_size,
                                                   peak, kv_dtype):
    cfg = _jax_cfg(quantized)
    engine_kw = dict(max_running=8, chunk=4, page_size=page_size,
                     max_model_len=32, num_pages=10, kv_dtype=kv_dtype)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    prompts, new_toks = _workload()

    jserving.reset_stats()
    jeng = jserving.LLMEngine(cfg, params, donate_pools=False, **engine_kw)
    j_out, j_streams, j_steps = _serve(jeng, prompts, new_toks)
    j_stats = jserving.serving_stats()

    tserving.reset_stats()
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    teng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu",
                              **engine_kw)
    t_out, t_streams, t_steps = _serve(teng, prompts, new_toks)
    t_stats = tserving.serving_stats()
    assert teng._quant_kv == jeng._quant_kv == (kv_dtype == "int8")
    assert teng._pool_bytes == jeng._pool_bytes

    assert [len(o) for o in t_out] == new_toks
    for i in range(10):
        assert t_out[i] == j_out[i], f"request {i} diverged"
        assert t_streams[i] == j_streams[i] == t_out[i]
    assert t_steps == j_steps
    # the workload really ran the batch full and forced preemption
    assert t_stats["peak_running"] == peak
    assert t_stats["requests_preempted"] > 0
    for key in ("requests_preempted", "prefill_tokens", "decode_tokens",
                "steps", "requests_finished", "peak_running"):
        assert t_stats[key] == j_stats[key], key
    assert teng.kv.allocator.num_allocated == 0 and teng.kv.audit()["ok"]


def _plan_key(plan, index):
    return ([(index[s.request.rid], s.slot, s.q_len, s.seq_len, s.produces)
             for s in plan.seqs], plan.bucket,
            [index[r.rid] for r in plan.preempted], plan.admission_blocked)


@pytest.mark.parametrize("num_pages,page,max_running,chunk", [
    (5, 4, 2, 8),      # the reference's preemption script
    (12, 4, 4, 4),
    (40, 8, 3, 16),
])
def test_scheduler_and_allocator_keep_the_reference_books(
        num_pages, page, max_running, chunk):
    kw = dict(max_running=max_running, chunk=chunk)
    jk = jkv.PagedKVCache(num_pages=num_pages, page_size=page, max_blocks=4)
    tk = tkv.PagedKVCache(num_pages=num_pages, page_size=page, max_blocks=4)
    js, ts = jsched.Scheduler(jk, **kw), tsched.Scheduler(tk, **kw)
    rng = np.random.RandomState(num_pages)
    jidx, tidx = {}, {}
    pending = [([int(t) for t in rng.randint(1, 9, rng.randint(1, 9))],
                int(rng.randint(1, 7))) for _ in range(6)]
    step = 0
    while pending or js.has_work():
        if pending and step % 2 == 0:
            prompt, n = pending.pop(0)
            jr = jsched.Request(prompt=list(prompt), max_new_tokens=n)
            tr = tsched.Request(prompt=list(prompt), max_new_tokens=n)
            jidx[jr.rid] = tidx[tr.rid] = len(jidx)
            js.add(jr)
            ts.add(tr)
        jp, tp = js.schedule(), ts.schedule()
        assert _plan_key(tp, tidx) == _plan_key(jp, jidx), f"step {step}"
        toks = {s.slot: (step * 7 + s.slot) % 11 for s in jp.seqs}
        jf, tf = js.apply(jp, toks, now_s=step), ts.apply(tp, toks,
                                                          now_s=step)
        assert [tidx[r.rid] for r in tf] == [jidx[r.rid] for r in jf]
        assert tk.allocator._free == jk.allocator._free
        for rj, rt in zip(sorted(jidx, key=jidx.get),
                          sorted(tidx, key=tidx.get)):
            assert tk.block_row(rt) == jk.block_row(rj)
        step += 1
        assert step < 500
    assert tk.audit()["ok"] and jk.audit()["ok"]
    assert tk.allocator.num_allocated == jk.allocator.num_allocated == 0


def test_admission_gate_matches_reference_hysteresis():
    jg, tg = jsched.AdmissionGate(6), tsched.AdmissionGate(6)
    depths = [0, 3, 5, 6, 7, 5, 4, 3, 2, 4, 6, 1, 0]
    assert [tg.check(d) for d in depths] == [jg.check(d) for d in depths]


def test_plan_capacity_matches_reference():
    jcfg = jllama.preset("llama7b")
    tcfg = tllama.preset("llama7b")
    for kv in ("bf16", "int8"):
        kw = dict(hbm_bytes=80 << 30, page_size=16, max_model_len=2048,
                  kv_dtype=kv)
        assert tkv.plan_capacity(tcfg, **kw) == jkv.plan_capacity(jcfg, **kw)


def test_engine_sheds_and_cancels():
    cfg = _port_cfg(_jax_cfg("off"))
    params = tllama.init_params(cfg, 0, device="cpu")
    eng = tserving.LLMEngine(cfg, params, device="cpu", max_running=2,
                             chunk=4, page_size=8, max_model_len=32,
                             max_queue=2)
    a = eng.add_request([1, 2, 3], 4)
    eng.add_request([4, 5], 4)
    with pytest.raises(tserving.AdmissionRejected):
        eng.add_request([6], 4)
    assert eng.cancel(a) and not eng.cancel(a)
    assert eng.state_of(a) is tserving.RequestState.CANCELLED
    out = eng.run()
    assert len(out) == 2 and eng.kv.audit()["ok"]
    assert eng.kv.allocator.num_allocated == 0


def test_engine_step_raises_on_non_finite_logits():
    # the always-on non-finite check raises inside the guarded step;
    # recovery classifies it, bisects and quarantines the poisoned
    # request instead of raising to the caller
    cfg = _port_cfg(_jax_cfg("off"))
    params = tllama.init_params(cfg, 0, device="cpu")
    params["lm_head"][:, 5] = float("nan")
    eng = tserving.LLMEngine(cfg, params, device="cpu", max_running=2,
                             chunk=4, page_size=8, max_model_len=32)
    rid = eng.add_request([1, 2, 3], 2)
    tserving.reset_stats()
    assert eng.step() == []
    assert eng.state_of(rid) is tserving.RequestState.FAILED
    err = eng.error_of(rid)
    assert isinstance(err, tserving.RequestQuarantined)
    assert "non_finite" in str(err) and "non-finite" in str(err)
    stats = tserving.serving_stats()
    assert stats["recoveries"] == 1 and stats["quarantined"] == 1
    assert eng.forwards == {"target": 1, "mirror": 0, "propose": 0,
                            "probe": 1}
    assert not eng.has_work() and eng.kv.audit()["ok"]
    assert eng.kv.allocator.num_allocated == 0


def test_int8_kv_replay_after_preemption_matches_unpreempted():
    """int8 writes are a function of the request's own tokens (stale
    bytes on recycled pages never reach a page scale), so an engine that
    preempts and replays gives the streams of one that never preempts,
    run after run — the reference's determinism contract."""
    cfg = _port_cfg(_jax_cfg("off"))
    params = tllama.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, 128, 6)] for _ in range(5)]
    kw = dict(device="cpu", max_running=4, chunk=4, page_size=8,
              max_model_len=32, kv_dtype="int8")

    def run(num_pages):
        tserving.reset_stats()
        eng = tserving.LLMEngine(cfg, params, num_pages=num_pages, **kw)
        rids = [eng.add_request(p, 20) for p in prompts]
        eng.run()
        assert eng.kv.audit()["ok"]
        return ([eng.output_of(r) for r in rids],
                tserving.serving_stats()["requests_preempted"])

    base, n0 = run(200)
    tight, n1 = run(10)
    tight2, _ = run(10)
    assert n0 == 0 and n1 > 0
    assert tight == tight2, "int8 replay is not deterministic"
    assert tight == base, "preemption replay diverged from the unpreempted"
    assert all(len(o) == 20 for o in base)


@pytest.mark.parametrize("kv_dtype,want", [
    ("int8", torch.int8), ("bf16", torch.bfloat16), (None, torch.float32),
    (torch.float32, torch.float32)])
def test_engine_kv_dtype_and_pool_bytes(kv_dtype, want):
    cfg = _port_cfg(_jax_cfg("off"))
    params = tllama.init_params(cfg, 0, device="cpu")
    eng = tserving.LLMEngine(cfg, params, device="cpu", max_running=2,
                             chunk=4, page_size=8, max_model_len=32,
                             kv_dtype=kv_dtype)
    L, nkv, P = 2, 2, eng.num_pages
    assert eng._kp.dtype == eng._vp.dtype == want
    page_bytes = 2 * L * nkv * 8 * cfg.head_dim * eng._kp.element_size()
    scale_bytes = 2 * L * nkv * P * 4 if want == torch.int8 else 0
    assert eng._scale_bytes == scale_bytes
    assert eng._pool_bytes == P * page_bytes + scale_bytes
    if want == torch.int8:
        assert eng._ks.shape == eng._vs.shape == (L, nkv, P)
        assert bool((eng._ks == 1).all() and (eng._vs == 1).all())
    else:
        assert eng._ks is None and eng._vs is None
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tserving.LLMEngine(cfg, params, device="cpu", max_model_len=32,
                           kv_dtype="fp4")
