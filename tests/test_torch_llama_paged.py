"""The port's Llama serving core against the JAX reference.

``params_from_jax`` must carry the reference's parameter tree across
unchanged (stacked layer leaves, int8 ``{"q", "scale"}`` leaves), and
the port's ``forward_paged`` must give the reference's logits and
updated K/V pools on the same inputs: float32 on the CPU, the GQA config
of the reference's serving tests, dense and int8 weights.

Tolerances: float32, atol 2e-5.  Both sides run the same operations;
what differs is the summation order inside matmuls, softmax and the
RMSNorm mean.  With int8 weights the activations are quantized per row;
the same float32 inputs give the same int8 values (exact parity is
tested in test_torch_int8_matmul.py), so the tolerance stays the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama

ATOL = 2e-5


def _jax_cfg(**kw):
    # tests/test_serving.py's engine config: GQA (4 q heads, 2 kv heads)
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                dtype=jnp.float32, use_remat=False)
    base.update(kw)
    return jllama.LlamaConfig(**base)


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("quantized", [False, True])
def test_params_from_jax_round_trip(quantized):
    cfg = _jax_cfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    if quantized:
        params = jllama.quantize_params(cfg, params)
    ref = _leaves(_np_tree(params))
    got = _leaves(convert.params_from_jax(_np_tree(params), device="cpu"))
    assert sorted(got) == sorted(ref)
    for name, arr in ref.items():
        t = got[name]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.numpy().dtype == arr.dtype, name
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)
    if quantized:
        wq = got["/layers/wq/q"]
        assert wq.dtype == torch.int8
        assert tuple(wq.shape) == (cfg.num_hidden_layers, 64, 64)
        assert tuple(got["/lm_head/scale"].shape) == (1, cfg.vocab_size)


def test_params_from_jax_carries_bfloat16_bits():
    x = jnp.asarray(np.random.RandomState(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = convert.params_from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def _paged_inputs(cfg, seed=0):
    """A mixed batch: slot 0 a prefill chunk crossing a page boundary,
    slot 1 a decode token, slot 2 a short chunk, slot 3 empty."""
    rng = np.random.RandomState(seed)
    L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    R, Tc, P, page, Bmax = 4, 4, 20, 8, 4
    kp = rng.standard_normal((L, nkv, P, page, d)).astype(np.float32)
    vp = rng.standard_normal((L, nkv, P, page, d)).astype(np.float32)
    tbl = (1 + rng.permutation(P - 1)[:R * Bmax]).reshape(R, Bmax)
    tbl = tbl.astype(np.int32)
    tbl[3] = 0                                   # the empty slot's row
    lens = np.asarray([10, 17, 3, 0], np.int32)
    qlens = np.asarray([4, 1, 3, 0], np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    return tokens, kp, vp, tbl, lens, qlens


@pytest.mark.parametrize("quantized", ["off", "on"])
def test_forward_paged_matches_jax(quantized):
    cfg = _jax_cfg(quantized=quantized)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    if quantized == "on":
        params = jllama.quantize_params(cfg, params)
    tokens, kp, vp, tbl, lens, qlens = _paged_inputs(cfg)

    logits_j, (kp_j, vp_j) = jllama.forward_paged(
        cfg, params, *(jnp.asarray(a) for a in
                       (tokens, kp, vp, tbl, lens, qlens)))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits_t, (kp_out, vp_out) = tllama.forward_paged(
        _port_cfg(cfg), tparams, torch.from_numpy(tokens), kp_t, vp_t,
        torch.from_numpy(tbl), torch.from_numpy(lens),
        torch.from_numpy(qlens))

    assert logits_t.dtype == torch.float32
    assert tuple(logits_t.shape) == (4, 4, cfg.vocab_size)
    # the pools were updated in place
    assert kp_out is kp_t and vp_out is vp_t
    logits_j = np.asarray(logits_j)
    for r, q in enumerate(qlens):     # padding rows are garbage by contract
        np.testing.assert_allclose(logits_t[r, :q].numpy(), logits_j[r, :q],
                                   rtol=0, atol=ATOL)
    # page 0 is the null page: padding tokens all land on its first slot
    np.testing.assert_allclose(kp_t[:, :, 1:].numpy(),
                               np.asarray(kp_j)[:, :, 1:], rtol=0, atol=ATOL)
    np.testing.assert_allclose(vp_t[:, :, 1:].numpy(),
                               np.asarray(vp_j)[:, :, 1:], rtol=0, atol=ATOL)
    # and something was written: the new k of slot 0's tokens
    assert not np.array_equal(kp_t.numpy(), kp)


def test_quantize_params_matches_jax():
    cfg = _jax_cfg(quantized="on")
    params = jllama.init_params(cfg, jax.random.PRNGKey(1))
    ref = _leaves(_np_tree(jllama.quantize_params(cfg, params)))
    got = _leaves(tllama.quantize_params(
        _port_cfg(cfg), convert.params_from_jax(_np_tree(params),
                                                device="cpu")))
    assert sorted(got) == sorted(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_rope_tables_match_jax():
    cfg = _jax_cfg()
    sin_j, cos_j = jllama._rope_tables(cfg, 64)
    sin_t, cos_t = tllama._rope_tables(_port_cfg(cfg), 64, "cpu")
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=0,
                               atol=1e-5)


def test_rms_norm_casts_before_the_weight_multiply():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = np.asarray(jllama._rms_norm(xb, wb, 1e-6).astype(jnp.float32))
    got = tllama._rms_norm(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


# ---------------------------------------------------------------------------
# int8 KV pools: quantize on write, dequantize on read
# ---------------------------------------------------------------------------

def _int8_steps(cfg):
    """Four steps of one engine-like batch over int8 pools (page 8):
    slot 0 prefills 5 then 8 tokens (the second chunk straddles its
    first two pages), slot 1 prefills 5 and decodes, slot 2 joins at
    step 1 on two recycled pages full of a previous owner's bytes and
    decodes into the second, slot 3 stays empty.  Returns the step
    inputs and the initial (pools, scales)."""
    rng = np.random.RandomState(3)
    L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    R, P, page, Bmax = 4, 20, 8, 4
    kp = np.zeros((L, nkv, P, page, d), np.int8)
    vp = np.zeros_like(kp)
    ks = np.ones((L, nkv, P), np.float32)
    vs = np.ones_like(ks)
    tbl = np.zeros((R, Bmax), np.int32)
    tbl[0] = [3, 4, 5, 6]
    tbl[1] = [7, 8, 0, 0]
    tbl[2] = [11, 12, 0, 0]                       # the recycled pages
    for pool in (kp, vp):
        pool[:, :, 11:13] = rng.randint(-127, 128, (L, nkv, 2, page, d))
    ks[:, :, 11:13] = 0.37
    vs[:, :, 11:13] = 0.21
    # (q_lens, seq_lens, Tc) per step
    script = [([5, 5, 0, 0], [5, 5, 0, 0], 8),
              ([8, 1, 7, 0], [13, 6, 7, 0], 8),
              ([1, 1, 1, 0], [14, 7, 8, 0], 1),
              ([1, 1, 1, 0], [15, 8, 9, 0], 1)]
    steps = []
    for qlens, lens, Tc in script:
        tokens = rng.randint(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
        steps.append((tokens, tbl, np.asarray(lens, np.int32),
                      np.asarray(qlens, np.int32)))
    return steps, (kp, vp, ks, vs)


@pytest.mark.parametrize("quantized", ["off", "on"])
def test_forward_paged_int8_kv_matches_jax(quantized):
    cfg = _jax_cfg(quantized=quantized)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    if quantized == "on":
        params = jllama.quantize_params(cfg, params)
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    steps, pools = _int8_steps(cfg)
    jp = [jnp.asarray(a) for a in pools]
    tp = [torch.from_numpy(a.copy()) for a in pools]
    for i, (tokens, tbl, lens, qlens) in enumerate(steps):
        logits_j, jp = jllama.forward_paged(
            cfg, params, *(jnp.asarray(a) for a in (tokens, jp[0], jp[1],
                                                    tbl, lens, qlens)),
            k_scales=jp[2], v_scales=jp[3])
        logits_t, out = tllama.forward_paged(
            _port_cfg(cfg), tparams, torch.from_numpy(tokens), tp[0], tp[1],
            torch.from_numpy(tbl), torch.from_numpy(lens),
            torch.from_numpy(qlens), k_scales=tp[2], v_scales=tp[3])
        # pools and scales updated in place, and returned
        assert all(a is b for a, b in zip(out, tp))
        logits_j = np.asarray(logits_j)
        for r, q in enumerate(qlens):   # padding rows are garbage
            ref = logits_j[r, :q]
            rel = np.abs(logits_t[r, :q].numpy() - ref).max() / max(
                np.abs(ref).max(), 1e-30) if q else 0.0
            assert rel <= 1e-4, f"step {i} slot {r}: logits rel {rel}"
        for got, ref, name in zip(tp[:2], jp[:2], ("k", "v")):
            diff = got.numpy().astype(np.int32) - np.asarray(ref, np.int32)
            # rounding ties after a different matmul order may move a
            # byte by one, and only rarely
            assert np.abs(diff).max() <= 1, f"step {i} {name} pool"
            assert np.count_nonzero(diff) <= 1e-3 * diff.size, \
                f"step {i} {name} pool: {np.count_nonzero(diff)} bytes"
        for got, ref, name in zip(tp[2:], jp[2:], ("k", "v")):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"step {i} {name} scales")
        # the null page is never written
        assert not tp[0][:, :, 0].any() and not tp[1][:, :, 0].any()
        assert torch.equal(tp[2][:, :, 0], torch.ones_like(tp[2][:, :, 0]))
    # the recycled pages' stale bytes reached neither page: everything
    # past slot 2's 9 tokens is zero
    assert not tp[0][:, :, 12, 1:].any() and not tp[1][:, :, 12, 1:].any()


def test_forward_paged_int8_write_ignores_stale_bytes():
    """The written bytes and scales are a function of the request's own
    tokens: the same steps over clean pages and over recycled pages
    full of stale bytes give identical pools."""
    cfg = _port_cfg(_jax_cfg())
    params = tllama.init_params(cfg, 0, device="cpu")
    steps, pools = _int8_steps(_jax_cfg())
    clean = [a.copy() for a in pools]
    for a in clean[:2]:
        a[:, :, 11:13] = 0
    for a in clean[2:]:
        a[:, :, 11:13] = 1.0
    runs = []
    for init in (pools, clean):
        tp = [torch.from_numpy(a.copy()) for a in init]
        for tokens, tbl, lens, qlens in steps:
            tllama.forward_paged(
                cfg, params, torch.from_numpy(tokens), tp[0], tp[1],
                torch.from_numpy(tbl), torch.from_numpy(lens),
                torch.from_numpy(qlens), k_scales=tp[2], v_scales=tp[3])
        runs.append(tp)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
