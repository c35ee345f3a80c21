"""The port's shared-prefix KV cache against the JAX reference.

The radix trie (``serving/prefix_cache.py``) and the page books of
``PagedKVCache`` must take the same steps as the reference's on one
scripted sequence of match, fork, donate and evict; and an engine with
``prefix_cache=True`` must stream what the JAX engine streams, token for
token, and keep the same books (prefix hit tokens, evicted pages,
preemptions, the page audit) — over float32 pages and over int8 pages,
where a copy-on-write fork copies the page's scales with it.  The
workload shares one system prompt that ends mid-page (so matches fork)
and runs on a pool small enough that cached pages are evicted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import kv_cache as tkv


def _books(kv):
    p = kv.prefix
    return (list(kv.allocator._free), dict(kv.allocator._ref),
            sorted(p.cached_pages()), vars(p.stats).copy(), kv.audit(),
            list(kv._pending_copies))


def test_trie_and_page_books_match_reference_on_a_script():
    page = 4
    caches = []
    for mod in (jkv, tkv):
        kv = mod.PagedKVCache(num_pages=14, page_size=page, max_blocks=6)
        kv.enable_prefix_cache()
        caches.append(kv)
    sys_prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]      # ends mid-page
    script = [
        ("grow", "a", 16), ("donate", "a", sys_prompt + [1] * 6, 16),
        ("match", "b", sys_prompt + [2, 2, 2]),            # full + fork
        ("drain",), ("grow", "b", 13),
        ("match", "c", sys_prompt[:6] + [3, 3, 3, 3]),     # 1 full + 2
        ("grow", "c", 10), ("drain",),
        ("release", "c"),
        ("donate", "b", sys_prompt + [2, 2, 2], 12),
        ("match", "d", [9, 9, 9, 9, 9]),                   # a miss
        ("grow", "d", 20), ("grow", "e", 12),              # pool pressure
        ("evict", 3), ("grow", "e", 12),
        ("match", "f", sys_prompt + [4]), ("release", "f"),  # fork dropped
        ("evict", 50), ("release", "d"), ("release", "e"),
    ]
    for i, op in enumerate(script):
        got = []
        for kv in caches:
            if op[0] == "grow":
                got.append(kv.grow(op[1], op[2]))
            elif op[0] == "donate":
                got.append(kv.donate(op[1], op[2], op[3]))
            elif op[0] == "match":
                got.append(kv.match_prefix(op[1], op[2]))
            elif op[0] == "drain":
                got.append(kv.drain_copies())
            elif op[0] == "release":
                got.append(kv.release(op[1]))
            elif op[0] == "evict":
                got.append(kv.evict_cached(op[1]))
            got.append(kv.block_row(op[1]) if len(op) > 1
                       and isinstance(op[1], str) else None)
        assert got[:2] == got[2:], f"op {i} {op}"
        assert _books(caches[1]) == _books(caches[0]), f"op {i} {op}"
    # the script reached every path it means to test
    st = caches[1].prefix.stats
    assert st.forks >= 2 and st.evicted_pages > 0
    assert st.hits >= 3 and st.lookups > st.hits
    assert caches[1].audit()["ok"]


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


def _serve(eng, prompts, n_new):
    """One warm request alone (it seeds the trie), then the rest: half
    up front, one more every other step."""
    rids = [eng.add_request(prompts[0], n_new)]
    while eng.has_work():
        eng.step()
    rest = list(prompts[1:])
    half = len(rest) // 2
    rids += [eng.add_request(p, n_new) for p in rest[:half]]
    pending, steps = rest[half:], 0
    while eng.has_work() or pending:
        if pending and steps % 2 == 1:
            rids.append(eng.add_request(pending.pop(0), n_new))
        eng.step()
        steps += 1
        assert steps < 2000
    return [eng.output_of(r) for r in rids]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_with_prefix_cache_matches_jax(kv_dtype):
    cfg = _jax_cfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.RandomState(5)
    sys_prompt = [int(t) for t in rng.randint(1, 128, 13)]   # 1 page + 5
    prompts = [sys_prompt + [int(t) for t in
                             rng.randint(1, 128, rng.randint(1, 6))]
               for _ in range(9)]
    kw = dict(max_running=4, chunk=4, page_size=8, max_model_len=40,
              num_pages=14, prefix_cache=True, kv_dtype=kv_dtype)

    jserving.reset_stats()
    jeng = jserving.LLMEngine(cfg, params, donate_pools=False, **kw)
    j_out = _serve(jeng, prompts, 10)
    j_stats = jserving.serving_stats()

    tserving.reset_stats()
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    teng = tserving.LLMEngine(_port_cfg(cfg), tparams, device="cpu", **kw)
    t_out = _serve(teng, prompts, 10)
    t_stats = tserving.serving_stats()

    assert t_out == j_out
    assert all(len(o) == 10 for o in t_out)
    for key in ("prefix_hit_tokens", "prefix_evicted_pages",
                "requests_preempted", "prefill_tokens", "decode_tokens",
                "steps", "requests_finished", "peak_running"):
        assert t_stats[key] == j_stats[key], key
    # the workload hit the cache, forked mid-page and evicted
    jst, tst = jeng.kv.prefix.stats, teng.kv.prefix.stats
    assert vars(tst) == vars(jst)
    assert tst.forks > 0 and tst.evicted_pages > 0
    assert t_stats["prefix_hit_tokens"] > 0
    assert teng.kv.audit() == jeng.kv.audit() and teng.kv.audit()["ok"]
    if kv_dtype == "int8":
        # every page the trie holds carries the reference's scales
        pages = sorted(teng.kv.prefix.cached_pages())
        np.testing.assert_allclose(
            teng._ks[:, :, pages].numpy(),
            np.asarray(jeng._ks)[:, :, pages], rtol=1e-6, atol=0)


def test_cow_fork_copies_page_and_scales():
    """A fork lands on the device before the forward reads it: the
    engine copies every layer's page and, with int8 pools, its k and v
    scales, in place."""
    cfg = _port_cfg(_jax_cfg())
    params = tllama.init_params(cfg, 0, device="cpu")
    eng = tserving.LLMEngine(cfg, params, device="cpu", max_running=2,
                             chunk=4, page_size=8, max_model_len=32,
                             kv_dtype="int8", prefix_cache=True)
    g = torch.Generator().manual_seed(0)
    for pool in (eng._kp, eng._vp):
        pool[:, :, 3] = torch.randint(-127, 128, pool[:, :, 3].shape,
                                      generator=g, dtype=torch.int8)
    eng._ks[:, :, 3] = 0.25
    eng._vs[:, :, 3] = 0.5
    kp, ks = eng._kp, eng._ks
    eng._apply_copies([(3, 6)])
    assert eng._kp is kp and eng._ks is ks            # in place
    for pool in (eng._kp, eng._vp, eng._ks, eng._vs):
        assert torch.equal(pool[:, :, 6], pool[:, :, 3])
