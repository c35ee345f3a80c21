"""The port's speculative decoding against the JAX reference engine.

A self-draft (the target as its own draft, the reference bench's shape)
must leave every greedy stream equal, token for token, to the JAX
engine's spec run on the same weights (crossed by ``params_from_jax``)
and prompts, with the same proposals accepted: with the prefix cache on
and off, dense and int8 weights, over float32 and int8 KV pages.  The
JAX side runs its Pallas kernels in interpret mode.  Over float pages
the spec streams also equal the port's own spec-off streams; over int8
pages the rejected tail of a verify row enters the page absmax, so
there the port is held to the JAX spec run only.  Under forced
preemption the page books balance at every step.  ``greedy_accept``'s
cases and the engine's checks of a spec config are the reference's.
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
from paddle_tpu.serving.spec_decode import greedy_accept as j_accept
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving.spec_decode import greedy_accept


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _jax_cfg(quantized="off"):
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


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(_jax_cfg(), jax.random.PRNGKey(0))


def _tparams(params):
    return convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _shared_prompts():
    """8 requests over 2 system prompts: shared head, divergent tail (the
    reference's shared workload)."""
    rng = np.random.RandomState(5)
    sys_a = [int(t) for t in rng.randint(1, 127, 13)]
    sys_b = [int(t) for t in rng.randint(1, 127, 9)]
    return [(sys_a if i % 2 == 0 else sys_b)
            + [int(t) for t in rng.randint(1, 127, 3 + i % 3)]
            for i in range(8)]


def _drive(eng, prompts, n_new, audit=False):
    rids = [eng.add_request(list(p), n_new) for p in prompts]
    steps = 0
    while eng.has_work():
        eng.step()
        if audit:
            assert eng.kv.audit()["ok"], f"books at step {steps}"
        steps += 1
        assert steps < 2000, "engine did not converge"
    return [eng.output_of(r) for r in rids]


KEYS = ("spec_proposed", "spec_accepted", "prefix_hit_tokens",
        "requests_preempted", "prefill_tokens", "decode_tokens", "steps",
        "requests_finished")


def _jax_run(cfg, params, prompts, n_new, spec, **kw):
    jserving.reset_stats()
    if spec:
        draft = (jllama.quantize_params(cfg, params)
                 if cfg.quantized == "on" else params)
        kw["spec"] = jserving.SpecDecodeConfig(cfg=cfg, params=draft, k=3)
    eng = jserving.LLMEngine(cfg, params, donate_pools=False, **kw)
    out = _drive(eng, prompts, n_new)
    return out, jserving.serving_stats(), eng


def _port_run(cfg, params, prompts, n_new, spec, audit=False, **kw):
    tserving.reset_stats()
    tcfg = _port_cfg(cfg)
    if spec:
        kw["spec"] = tserving.SpecDecodeConfig(tcfg, params, k=3)
    eng = tserving.LLMEngine(tcfg, params, device="cpu", **kw)
    out = _drive(eng, prompts, n_new, audit)
    return out, tserving.serving_stats(), eng


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("quantized", ["off", "on"])
@pytest.mark.parametrize("prefix", [False, True])
def test_spec_streams_match_jax_engine(prefix, quantized, kv_dtype,
                                       jparams):
    cfg = _jax_cfg(quantized)
    prompts, n_new = _shared_prompts(), 8
    kw = dict(max_running=4, chunk=8, page_size=4, num_pages=200,
              prefix_cache=prefix, kv_dtype=kv_dtype)
    tparams = _tparams(jparams)
    j_out, j_stats, _ = _jax_run(cfg, jparams, prompts, n_new, True, **kw)
    t_out, t_stats, teng = _port_run(cfg, tparams, prompts, n_new, True,
                                     **kw)
    assert all(len(o) == n_new for o in t_out)
    for i in range(len(prompts)):
        assert t_out[i] == j_out[i], f"request {i} diverged from JAX"
    for key in KEYS:
        assert t_stats[key] == j_stats[key], key
    assert 0 < t_stats["spec_accepted"] <= t_stats["spec_proposed"]
    assert (t_stats["prefix_hit_tokens"] > 0) == prefix
    assert teng.kv.audit()["ok"]
    # one verify, one mirror and k proposals a speculating step
    fw = teng.forwards
    assert fw["target"] == fw["mirror"] == t_stats["steps"]
    assert fw["propose"] > 0 and fw["propose"] % 3 == 0
    # the self-draft shares the engine's (int8 under "on") weights and
    # keeps its pools in the model's dtype whatever the target's pages
    assert teng._draft.params is teng.params
    assert teng._draft._kp.dtype == torch.float32
    if quantized == "on":
        assert isinstance(teng.params["layers"]["wq"], dict)
    if kv_dtype is None:
        # over float pages speculation changes no stream
        base, _, _ = _port_run(cfg, tparams, prompts, n_new, False, **kw)
        assert t_out == base


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spec_under_forced_preemption_keeps_the_books(kv_dtype, jparams):
    """A pool of 20 pages under prefix + spec: cached pages are evicted
    and running requests preempted; the page audit holds after every
    step and the streams still equal the JAX engine's."""
    cfg = _jax_cfg()
    prompts, n_new = _shared_prompts()[:5], 8
    kw = dict(max_running=4, chunk=8, page_size=4, num_pages=20,
              prefix_cache=True, kv_dtype=kv_dtype)
    j_out, j_stats, _ = _jax_run(cfg, jparams, prompts, n_new, True, **kw)
    t_out, t_stats, teng = _port_run(cfg, _tparams(jparams), prompts,
                                     n_new, True, audit=True, **kw)
    assert t_out == j_out
    for key in KEYS + ("prefix_evicted_pages",):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["requests_preempted"] > 0
    assert t_stats["prefix_evicted_pages"] > 0
    assert t_stats["spec_accepted"] > 0


@pytest.mark.parametrize("drafts,row,want", [
    ([5, 7], [5, 7, 9], [5, 7, 9]),     # all accepted
    ([5, 8], [5, 7, 9], [5, 7]),        # one accepted
    ([4, 7], [5, 7, 9], [5]),           # none accepted
    ([], [5], [5]),                     # k = 0: a plain decode
])
def test_greedy_accept_matches_reference(drafts, row, want):
    assert greedy_accept(drafts, row) == j_accept(drafts, row) == want


def test_engine_rejects_bad_spec_config():
    cfg = _port_cfg(_jax_cfg())
    params = tllama.init_params(cfg, 0, device="cpu")
    bad = dataclasses.replace(cfg, vocab_size=64)
    with pytest.raises(ValueError, match="vocab"):
        tserving.LLMEngine(cfg, params, device="cpu", chunk=8,
                           max_model_len=32,
                           spec=tserving.SpecDecodeConfig(bad, params, k=3))
    for k in (4, 0):
        with pytest.raises(ValueError, match="spec.k"):
            tserving.LLMEngine(cfg, params, device="cpu", chunk=4,
                               max_model_len=32,
                               spec=tserving.SpecDecodeConfig(cfg, params,
                                                              k=k))


def test_draft_with_its_own_weights_and_pool_dtype():
    """A draft given other params gets its own copy on the engine's
    device (quantized under its own config), and its pools follow the
    draft config's dtype, never int8, under an int8-KV target."""
    cfg = _port_cfg(_jax_cfg("on"))
    params = tllama.init_params(cfg, 0, device="cpu")
    dcfg = dataclasses.replace(cfg, num_hidden_layers=1, quantized="off",
                               dtype=torch.bfloat16)
    dparams = tllama.init_params(dcfg, 1, device="cpu")
    eng = tserving.LLMEngine(cfg, params, device="cpu", chunk=8,
                             page_size=4, max_model_len=32, kv_dtype="int8",
                             spec=tserving.SpecDecodeConfig(dcfg, dparams))
    d = eng._draft
    assert d.params is not eng.params
    assert not isinstance(d.params["layers"]["wq"], dict)
    assert d._kp.dtype == d._vp.dtype == torch.bfloat16
    assert d._kp.shape == (1, cfg.num_key_value_heads, eng.num_pages, 4,
                           cfg.head_dim)
    assert d.pool_bytes == 2 * d._kp.numel() * 2
    rids = [eng.add_request([1, 2, 3, 4, 5], 6) for _ in range(2)]
    eng.run()
    assert all(len(eng.output_of(r)) == 6 for r in rids)
    assert eng.kv.audit()["ok"]
    kp = d._kp
    eng.shutdown()
    assert d._kp is None and eng._kp is None and kp is not None
