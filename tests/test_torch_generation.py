"""The port's KV-cache generation (``models/decoding.py``, Llama's
``forward_with_cache`` / ``generate`` / ``LlamaForCausalLM``) against the
JAX reference on the CPU.

Weights are drawn by JAX and cross with ``params_from_jax``; inputs come
from numpy seeds.  Tolerances: ``cached_attention_core`` f32 atol 1e-5;
greedy tokens exactly equal (dense, GQA, MoE, int8 weights quantized by
JAX); ``LlamaForCausalLM``'s logits and loss f32 atol 1e-4.  Sampling
cannot match JAX's bits (``jax.random`` keys against a
``torch.Generator``), so it is held to its law: a seed gives the same
tokens, a sampled token lies in its step's top-k, temperature 0 is
greedy, and 20k draws from one logits row pass a chi-square test
against softmax(logits / T) at p > 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paddle_tpu.models import decoding as jdec
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import convert, decoding
from paddle_tpu_torch.models import llama as tllama

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=64)
CASES = {
    "dense": {},
    "gqa": dict(num_key_value_heads=2),
    "moe": dict(moe_num_experts=4),
}


def _cfgs(**over):
    fields = dict(BASE, **over)
    return (jllama.LlamaConfig(dtype=jnp.float32, use_remat=False,
                               fused_blocks="off", **fields),
            tllama.LlamaConfig(dtype=torch.float32, use_remat=False,
                               **fields))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model(case, seed=0, quant=False):
    jcfg, tcfg = _cfgs(**CASES[case])
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    if quant:
        jcfg.quantized = "on"
        jp = jllama.quantize_params(jcfg, jp)
        tcfg.quantized = "on"
    return jcfg, tcfg, jp, convert.params_from_jax(_np(jp), device="cpu")


def _prompt(B=2, P=5, seed=1, vocab=BASE["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# cached attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nkv,T,pos", [(4, 3, 0), (2, 1, 6), (1, 4, 5)])
def test_cached_attention_core_matches_jax(nkv, T, pos):
    rng = np.random.default_rng(nkv * 10 + T)
    B, nh, d, S_max = 3, 4, 8, 16
    q = rng.standard_normal((B, T, nh, d)).astype(np.float32)
    k = rng.standard_normal((B, T, nkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, nkv, d)).astype(np.float32)
    # garbage everywhere in the cache: what lies past a row's length must
    # not reach its output
    ck = (100 * rng.standard_normal((B, S_max, nkv, d))).astype(np.float32)
    cv = (100 * rng.standard_normal((B, S_max, nkv, d))).astype(np.float32)
    lengths = np.array([pos + T, pos + T - 1, max(pos + 1, 1)], np.int32)
    for lens in (None, lengths):
        ref = jdec.cached_attention_core(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ck),
            jnp.asarray(cv), pos, None if lens is None else jnp.asarray(lens))
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        got = decoding.cached_attention_core(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tk, tv, pos, None if lens is None else torch.from_numpy(lens))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)
        assert got[1] is tk and got[2] is tv        # written in place


def test_init_kv_cache_is_kv_head_width():
    cache = decoding.init_kv_cache(2, 3, 16, 2, 8, torch.float32, "cpu")
    assert cache.k.shape == (2, 3, 16, 2, 8) and cache.v.dtype == \
        torch.float32 and not cache.k.any()


# ---------------------------------------------------------------------------
# greedy generation against JAX, token for token
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,quant", [("dense", False), ("gqa", False),
                                        ("moe", False), ("dense", True),
                                        ("gqa", True)])
def test_greedy_generate_matches_jax(case, quant):
    jcfg, tcfg, jp, tp = _model(case, quant=quant)
    if quant:
        assert isinstance(tp["layers"]["wq"], dict)
        assert isinstance(tp["lm_head"], dict)
    ids = _prompt()
    ref = np.asarray(jllama.generate(jcfg, jp, jnp.asarray(ids), 8))
    got = tllama.generate(tcfg, tp, ids, 8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["dense", "gqa"])
def test_cached_decode_equals_uncached_greedy(case):
    _, tcfg, _, tp = _model(case, seed=3)
    ids = torch.from_numpy(_prompt(seed=4)).long()
    seq = ids
    for _ in range(6):
        logits, _ = tllama.forward_pure(tcfg, tp, seq)
        seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    got = tllama.generate(tcfg, tp, ids, 6)
    assert torch.equal(got, seq[:, ids.shape[1]:])


def test_prefill_logits_match_forward_pure_and_jax():
    jcfg, tcfg, jp, tp = _model("gqa", seed=5)
    ids = _prompt(P=9, seed=6)
    cache = decoding.init_kv_cache(2, 2, 12, 2, 16, torch.float32, "cpu")
    got, _ = tllama.forward_with_cache(tcfg, tp, torch.from_numpy(ids),
                                       cache, 0)
    jcache = jdec.init_kv_cache(2, 2, 12, 2, 16, jnp.float32)
    ref, _ = jllama.forward_with_cache(jcfg, jp, jnp.asarray(ids), jcache, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    full, _ = tllama.forward_pure(tcfg, tp, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


def test_eos_freezes_the_row_as_jax_does():
    jcfg, tcfg, jp, tp = _model("dense", seed=7)
    ids = _prompt(B=3, seed=8)
    free = tllama.generate(tcfg, tp, ids, 8).numpy()
    eos = int(free[0, 2])           # row 0 emits it at step 2
    ref = np.asarray(jllama.generate(jcfg, jp, jnp.asarray(ids), 8,
                                     eos_token_id=eos))
    got = tllama.generate(tcfg, tp, ids, 8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, ref)
    first = int(np.argmax(got[0] == eos))
    assert first <= 2 and (got[0, first:] == eos).all()


def test_prompt_overflow_raises():
    _, tcfg, _, tp = _model("dense")
    ids = _prompt(P=60)
    with pytest.raises(ValueError, match="exceeds max_position_embeddings"):
        tllama.generate(tcfg, tp, ids, 5)


# ---------------------------------------------------------------------------
# the eager class
# ---------------------------------------------------------------------------

def test_llama_for_causal_lm_matches_the_reference_facade():
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import Tensor
    tpaddle.set_device("cpu")
    jcfg, tcfg = _cfgs(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jcfg)
    tm = tllama.LlamaForCausalLM(tcfg)
    jsd = jm.state_dict()
    assert list(tm.state_dict()) == list(jsd)
    tm.set_state_dict({k: np.asarray(v._array) for k, v in jsd.items()})
    ids = _prompt(seed=9, P=7)
    labels = _prompt(seed=10, P=7)
    jloss, jlogits = jm(ids, labels=labels)
    loss, logits = tm(ids, labels=torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._array),
                               atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(np.asarray(jloss._array)),
                               atol=1e-4)
    # the forward is forward_pure over the layer's own tensors
    ref, _ = tllama.forward_pure(tcfg, tm._tree(), torch.from_numpy(ids))
    assert torch.equal(tm(ids)._t, ref)
    loss.backward()
    assert all(p.grad is not None for p in tm.parameters())
    # generate returns a Tensor equal to the reference facade's
    out = tm.generate(ids, 5)
    assert isinstance(out, Tensor)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jm.generate(ids, 5)._array))


def test_llama_for_causal_lm_draws_seed_zero_on_its_device():
    import paddle_tpu_torch as tpaddle
    tpaddle.set_device("cpu")
    _, tcfg = _cfgs()
    tm = tllama.LlamaForCausalLM(tcfg)
    ref = tllama.init_params(tcfg, 0, device="cpu")
    for (name, p), (_, r) in zip(tm.state_dict().items(),
                                 tllama._flatten_params(ref)):
        assert torch.equal(p._t, r), name
    assert tm.parameters()[0].place.is_cpu_place()


# ---------------------------------------------------------------------------
# sampling, held to its law
# ---------------------------------------------------------------------------

def test_same_seed_same_tokens_and_temperature_zero_is_greedy():
    _, tcfg, _, tp = _model("gqa", seed=11)
    ids = _prompt(seed=12)
    a = tllama.generate(tcfg, tp, ids, 6, temperature=0.8, top_k=5, rng=3)
    b = tllama.generate(tcfg, tp, ids, 6, temperature=0.8, top_k=5, rng=3)
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    c = tllama.generate(tcfg, tp, ids, 6, temperature=0.8, top_k=5, rng=gen)
    assert torch.equal(a, c)
    greedy = tllama.generate(tcfg, tp, ids, 6)
    assert torch.equal(tllama.generate(tcfg, tp, ids, 6, temperature=0.0,
                                       top_k=5, rng=9), greedy)
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(decoding.sample_logits(logits, 0.0, 3),
                       logits.argmax(-1))


def test_sampled_tokens_lie_in_each_steps_top_k():
    _, tcfg, _, tp = _model("dense", seed=13)
    ids = torch.from_numpy(_prompt(B=4, seed=14)).long()
    k = 3
    toks = tllama.generate(tcfg, tp, ids, 8, temperature=1.5, top_k=k,
                           rng=0)
    seq = torch.cat([ids, toks], dim=1)
    logits, _ = tllama.forward_pure(tcfg, tp, seq)
    P = ids.shape[1]
    for t in range(toks.shape[1]):
        step = logits[:, P - 1 + t]
        kth = torch.topk(step, k, dim=-1).values[:, -1]
        chosen = step.gather(-1, toks[:, t:t + 1])[:, 0]
        assert bool((chosen >= kth - 1e-5).all()), t


@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.3, 4)])
def test_sampling_frequencies_follow_softmax(temperature, top_k):
    n, V = 20000, 8
    row = torch.tensor([1.2, 0.3, -0.5, 2.0, 0.0, -1.5, 0.9, 0.4])
    gen = torch.Generator().manual_seed(1234)
    draws = decoding.sample_logits(row.expand(n, V), temperature, top_k,
                                   gen)
    counts = np.bincount(draws.numpy(), minlength=V)
    scaled = row / temperature
    if top_k:
        kth = torch.topk(scaled, top_k).values[-1]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    p = torch.softmax(scaled.double(), 0).numpy()
    keep = p > 0
    assert counts[~keep].sum() == 0
    _, pval = stats.chisquare(counts[keep], n * p[keep])
    assert pval > 1e-3, (counts, n * p)
