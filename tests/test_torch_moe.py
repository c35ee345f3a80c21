"""The port's MoE layer against the JAX reference, and the flag routing
of ``fused_blocks`` / ``quantized`` left at None.

Both packages run in float32 on the CPU from the same weights (JAX's
``init_params``, crossed by ``params_from_jax``) and the same inputs
from numpy seeds.  The model is ``llama-debug`` (or the serving tests'
GQA config) with 4 experts, top 2, at capacity factors that overflow
experts (0.5 and 1.0) and at the reference's default 1.25.

- ``_moe_mlp``: the routing first (``torch.topk`` and ``lax.top_k``
  could order a near-tie differently, and a flipped expert changes a
  token's output entirely): the chosen experts and the kept assignments
  are equal, the top-k probabilities within 1e-6; then the output (atol
  2e-6), the aux (rtol 1e-6) and the gradients of the input and of every
  weight (atol 2e-6 + rtol 1e-4).
- ``loss_fn`` and its gradients under no remat, "full" and "dots":
  loss atol 2e-5, gradients atol 2e-5 + rtol 1e-3, as
  ``tests/test_torch_llama_train.py`` holds the dense model.
- ``quantize_params`` under MoE quantizes ``lm_head`` alone, as the
  reference does; ``forward_paged`` routes every token slot (padding
  slots and the empty row take capacity, as in the reference): logits
  of the valid rows atol 2e-5 over float32 pools, dense and int8
  weights.  Over int8 pools the written bytes may differ by one at a
  rounding tie (the matmuls sum in another order; at most 0.1 % of
  them, as ``tests/test_torch_llama_paged.py`` holds the dense model),
  and one such byte moves its request's logits by ~1.7e-4 of their
  largest in this batch with the dense MLP as with MoE: rel 5e-4.
- The serving engines of both packages on the same workload with int8
  weights (``quantized="on"``), float32 and int8 KV pages: the greedy
  streams are equal token for token.
- The world-size-1 train step against the reference's
  ``build_train_step`` on one device over three AdamW steps: losses atol
  2e-5, params as ``tests/test_torch_dist_train.py`` holds them.
- ``FLAGS_tpu_fused_blocks`` and ``FLAGS_tpu_quantized`` at each value,
  with the config at None: the blocks that engage and whether the
  engine quantizes at build are the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torch_dist_workers as workers
from test_torch_serving import _serve, _workload
from paddle_tpu import serving as jserving
from paddle_tpu.core import flags as jflags
from paddle_tpu.distributed.mesh import HybridTopology as JTopology
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama

MOE = dict(moe_num_experts=4, moe_top_k=2)
FIELDS = dict(jllama.PRESETS["llama-debug"], **MOE)
# the serving tests' GQA config (4 heads over 2 kv heads)
SERVE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, **MOE)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(fields=FIELDS, **kw):
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                              **fields, **kw)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, fused_blocks="off",
                              **fields, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    return _np(jllama.init_params(jcfg, jax.random.PRNGKey(seed)))


def _jax_route(cfg, router, xt):
    """The reference's routing lines of ``_moe_mlp`` (llama.py:370-384)."""
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    T = xt.shape[0]
    C = max(1, int(cfg.moe_capacity_factor * T * K / E))
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    gate_vals, gate_idx = lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(T * K, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(T, K, E)
                  * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(gate_vals),
            np.asarray(gate_idx), np.asarray(pos < C))


def _layer_inputs(jcfg, cf_seed):
    params = _params(jcfg)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = np.random.default_rng(cf_seed).standard_normal(
        (2, 16, jcfg.hidden_size)).astype(np.float32)
    return lp, x


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_routing_matches_jax(cf):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    lp, x = _layer_inputs(jcfg, 1)
    probs_j, vals_j, idx_j, keep_j = _jax_route(
        jcfg, jnp.asarray(lp["router"]), jnp.asarray(x.reshape(-1, 64)))
    probs, vals, idx, keep, slot, C = tllama._moe_route(
        tcfg, torch.from_numpy(lp["router"].copy()),
        torch.from_numpy(x.reshape(-1, 64)), 2)
    # how far apart the two top-k's probabilities are: far above the
    # summation-order noise, so no choice is a near tie
    top = np.sort(probs_j, axis=-1)[:, ::-1]
    assert (top[:, 1] - top[:, 2]).min() > 1e-5
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_allclose(probs.numpy(), probs_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        vals.numpy(), vals_j / vals_j.sum(-1, keepdims=True), atol=1e-6)
    # the kept slots are unique and inside the buffer; dropped ones go
    # to the trash row
    kept = slot.numpy()[keep.numpy().reshape(-1)]
    assert len(set(kept)) == kept.size and kept.max() < 4 * C
    assert (slot.numpy()[~keep.numpy().reshape(-1)] == 4 * C).all()
    if cf < 1.25:
        assert not keep_j.all()          # experts overflow here


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_mlp_matches_jax(cf):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    lp, x = _layer_inputs(jcfg, 2)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)

    def jfn(xx, p):
        out, aux = jllama._moe_mlp(jcfg, p, xx)
        return jnp.sum(out * dy) + aux

    (out_j, aux_j) = jllama._moe_mlp(jcfg, {k: jnp.asarray(v)
                                            for k, v in lp.items()},
                                     jnp.asarray(x))
    gx_j, glp_j = jax.grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    tlp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
           for k, v in lp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tllama._moe_mlp(tcfg, tlp, tx)
    ((out * torch.from_numpy(dy)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(aux.item(), float(aux_j), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j),
                               atol=2e-6, rtol=1e-4)
    for k, g in glp_j.items():
        if k in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(tlp[k].grad.numpy(), np.asarray(g),
                                       atol=2e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax(remat):
    kw = dict(moe_capacity_factor=1.0, use_remat=remat != "none",
              remat_policy="dots" if remat == "none" else remat)
    jcfg, tcfg = _cfgs(**kw)
    params = _params(jcfg)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, 256, (4, 32)).astype(np.int32)
             for k in ("input_ids", "labels")}
    (jtotal, jce), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, batch), has_aux=True))(params)
    tparams = convert.params_from_jax(params, device="cpu")
    for t in tllama._paths(tparams).values():
        t.requires_grad_(True)
    total, ce = tllama.loss_fn(tcfg, tparams, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert abs(total.item() - float(jtotal)) <= 2e-5
    assert abs(ce.item() - float(jce)) <= 2e-5
    assert total.item() != ce.item()           # the aux is in the loss
    for k, g in tllama._paths(_np(jgrads)).items():
        np.testing.assert_allclose(tllama._paths(tparams)[k].grad.numpy(),
                                   g, atol=2e-5, rtol=1e-3, err_msg=k)


def test_init_params_and_quantize_params_layout_match_jax():
    """init_params' leaves have the reference's shapes and dtypes (router
    f32); quantize_params quantizes lm_head alone, to the same bytes."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    mine = tllama._paths(tllama.init_params(tcfg, 0, device="cpu"))
    ref = tllama._paths(params)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in mine.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in ref.items()}
    jq = tllama._paths(_np(jllama.quantize_params(jcfg, params)))
    tq = tllama._paths(tllama.quantize_params(
        tcfg, convert.params_from_jax(params, device="cpu")))
    assert sorted(jq) == sorted(tq)
    assert [k for k in tq if k.endswith(("/q", "/scale"))] == \
        ["lm_head/q", "lm_head/scale"]
    for k, v in jq.items():
        np.testing.assert_allclose(tq[k].numpy(), v, rtol=1e-6, atol=0,
                                   err_msg=k)


def _paged_inputs(cfg, quant, seed=0):
    """A mixed batch as ``tests/test_torch_llama_paged.py``'s: slot 0 a
    prefill chunk crossing a page boundary, slot 1 a decode token, slot
    2 a short chunk, slot 3 empty; 7 of the 16 token slots are padding
    or empty, and take capacity."""
    rng = np.random.RandomState(seed)
    L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    R, Tc, P, page, Bmax = 4, 4, 20, 8, 4
    if quant:
        kp = rng.randint(-127, 128, (L, nkv, P, page, d)).astype(np.int8)
        vp = rng.randint(-127, 128, (L, nkv, P, page, d)).astype(np.int8)
        scales = [np.full((L, nkv, P), s, np.float32) for s in (0.02, 0.03)]
    else:
        kp = rng.standard_normal((L, nkv, P, page, d)).astype(np.float32)
        vp = rng.standard_normal((L, nkv, P, page, d)).astype(np.float32)
        scales = []
    tbl = (1 + rng.permutation(P - 1)[:R * Bmax]).reshape(R, Bmax)
    tbl = tbl.astype(np.int32)
    tbl[3] = 0
    lens = np.asarray([10, 17, 3, 0], np.int32)
    qlens = np.asarray([4, 1, 3, 0], np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    return tokens, [kp, vp, *scales], tbl, lens, qlens


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("quantized", ["off", "on"])
def test_forward_paged_matches_jax(quantized, kv):
    jcfg, tcfg = _cfgs(SERVE, moe_capacity_factor=1.0, quantized=quantized)
    params = _params(jcfg)
    if quantized == "on":
        params = _np(jllama.quantize_params(jcfg, params))
    tokens, pools, tbl, lens, qlens = _paged_inputs(jcfg, kv == "int8")
    scales = {}
    if kv == "int8":
        scales = dict(k_scales=jnp.asarray(pools[2]),
                      v_scales=jnp.asarray(pools[3]))
    logits_j, pools_j = jllama.forward_paged(
        jcfg, params, *(jnp.asarray(a) for a in (tokens, pools[0],
                                                  pools[1], tbl, lens,
                                                  qlens)), **scales)
    tp = [torch.from_numpy(a.copy()) for a in pools]
    tscales = dict(k_scales=tp[2], v_scales=tp[3]) if kv == "int8" else {}
    logits_t, _ = tllama.forward_paged(
        tcfg, convert.params_from_jax(params, device="cpu"),
        torch.from_numpy(tokens), tp[0], tp[1], torch.from_numpy(tbl),
        torch.from_numpy(lens), torch.from_numpy(qlens), **tscales)
    # the padding slots overflow an expert here, as in the reference
    with tllama.moe_routing() as r:
        tllama.forward_paged(
            tcfg, convert.params_from_jax(params, device="cpu"),
            torch.from_numpy(tokens), tp[0].clone(), tp[1].clone(),
            torch.from_numpy(tbl), torch.from_numpy(lens),
            torch.from_numpy(qlens),
            **{k: v.clone() for k, v in tscales.items()})
    assert r.dropped_share() > 0
    logits_j = np.asarray(logits_j)
    for row, q in enumerate(qlens):
        got, ref = logits_t[row, :q].numpy(), logits_j[row, :q]
        if kv == "f32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        elif q:
            assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max()
    if kv == "int8":
        for got, ref in zip(tp[:2], pools_j[:2]):
            diff = got.numpy().astype(np.int32) - np.asarray(ref, np.int32)
            assert np.abs(diff).max() <= 1
            assert np.count_nonzero(diff) <= 1e-3 * diff.size


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_streams_match_jax_engine(kv_dtype):
    """Both engines serve the same 10 requests (continuous admission, 8
    slots, chunk 4) with int8 weights: the MoE layers stay dense and the
    head is int8 in both, and every stream is equal token for token."""
    jcfg, tcfg = _cfgs(SERVE, moe_capacity_factor=1.0, quantized="on")
    jcfg = dataclasses.replace(jcfg, use_remat=False)
    params = _params(jcfg)
    kw = dict(max_running=8, chunk=4, page_size=8, max_model_len=32,
              kv_dtype=kv_dtype)
    prompts, new_toks = _workload()
    jserving.reset_stats()
    jeng = jserving.LLMEngine(jcfg, jax.tree_util.tree_map(
        jnp.asarray, params), donate_pools=False, **kw)
    j_out, j_streams, j_steps = _serve(jeng, prompts, new_toks)
    tserving.reset_stats()
    teng = tserving.LLMEngine(tcfg, convert.params_from_jax(
        params, device="cpu"), device="cpu", **kw)
    with tllama.moe_routing() as r:
        t_out, t_streams, t_steps = _serve(teng, prompts, new_toks)
    for eng in (jeng, teng):
        assert isinstance(eng.params["lm_head"], dict)
        assert not isinstance(eng.params["layers"]["w_gate"], dict)
    assert r.dropped_share() > 0
    assert t_steps == j_steps
    for i in range(10):
        assert t_out[i] == j_out[i], f"request {i} diverged"
        assert t_streams[i] == j_streams[i] == t_out[i]
    assert teng.kv.audit()["ok"]


def test_world_size_one_step_matches_jax():
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.0)
    params = _params(jcfg)
    rng = np.random.default_rng(5)
    batches = [{k: rng.integers(0, 256, (4, 32)).astype(np.int32)
                for k in ("input_ids", "labels")} for _ in range(3)]
    topo = JTopology(devices=jax.devices()[:1])
    jstep, jinit = jllama.build_train_step(jcfg, topo)
    jp, state = jinit(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda ref, x: jax.device_put(
        x, ref.sharding), jp, params)
    step, init = tllama.build_train_step(tcfg, device="cpu")
    tp, opt = init(params=convert.params_from_jax(params, device="cpu"))
    for b in batches:
        jp, state, jm = jstep(jp, state, b)
        tp, opt, m = step(tp, opt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert abs(m["loss"].item() - float(jm["loss"])) <= 2e-5
        assert abs(m["ce"].item() - float(jm["ce"])) <= 2e-5
    workers.close_params({k: v.detach().numpy() for k, v in
                          tllama._paths(tp).items()},
                         tllama._paths(_np(jp)), 3)


@pytest.fixture
def flag_state():
    """Both registries' routing flags, restored after the test; the
    reference's Pallas interpreter on, so that "on" can engage its fused
    blocks on the CPU as the port's plain versions do."""
    from paddle_tpu.ops import pallas_ops
    names = ["FLAGS_tpu_fused_blocks", "FLAGS_tpu_quantized"]
    old = (jflags.get_flags(names), tflags.get_flags(names),
           pallas_ops._INTERPRET)
    pallas_ops._INTERPRET = True
    yield
    jflags.set_flags(old[0])
    tflags.set_flags(old[1])
    pallas_ops._INTERPRET = old[2]


@pytest.mark.parametrize("value", ["auto", "on", "off"])
@pytest.mark.parametrize("moe", [False, True])
def test_fused_blocks_flag_routes_like_jax(flag_state, value, moe):
    fields = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, max_position_embeddings=256,
                  **(MOE if moe else {}))
    assert tflags.flag("FLAGS_tpu_fused_blocks") == "auto"
    jflags.set_flags({"FLAGS_tpu_fused_blocks": value})
    tflags.set_flags({"FLAGS_tpu_fused_blocks": value})
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **fields)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **fields)
    assert jcfg.fused_blocks is None and tcfg.fused_blocks is None
    x = np.zeros((1, 256, 256), np.float32)
    want = tuple(bool(v) for v in jllama._fused_block_modes(
        jcfg, jnp.asarray(x), None, False))
    assert tllama._fused_block_modes(tcfg, torch.from_numpy(x)) == want
    assert want == ((value == "on", value == "on" and not moe))


@pytest.mark.parametrize("value", ["auto", "on", "off"])
def test_quantized_flag_routes_like_jax(flag_state, value):
    assert tflags.flag("FLAGS_tpu_quantized") == "auto"
    jflags.set_flags({"FLAGS_tpu_quantized": value})
    tflags.set_flags({"FLAGS_tpu_quantized": value})
    jcfg, tcfg = _cfgs(dict(jllama.PRESETS["llama-debug"]))
    assert jcfg.quantized is None and tcfg.quantized is None
    assert tllama._quantized_mode(tcfg, "cpu") == \
        jllama._quantized_mode(jcfg) == (value == "on")
    params = _params(jcfg)
    kw = dict(max_running=2, chunk=4, page_size=8, max_model_len=32)
    jeng = jserving.LLMEngine(jcfg, jax.tree_util.tree_map(
        jnp.asarray, params), donate_pools=False, **kw)
    teng = tserving.LLMEngine(tcfg, convert.params_from_jax(
        params, device="cpu"), device="cpu", **kw)
    assert isinstance(teng.params["lm_head"], dict) == \
        isinstance(jeng.params["lm_head"], dict) == (value == "on")
    assert isinstance(teng.params["layers"]["wq"], dict) == (value == "on")
