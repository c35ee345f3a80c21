"""The port's train step against the JAX reference on the CPU.

``forward_pure`` logits, ``loss_fn`` and the gradient of every parameter
on two float32 configs: ``llama-debug`` and ``bench.py``'s CPU smoke
shape (bench.py:107-113).  Weights cross with ``params_from_jax``; the
JAX side runs the unfused jnp path (``fused_blocks="off"``, flash on
the CPU falls back to ``_attention_jnp``).  Then the remat policies
against each other, and the bench's AdamW step against
``optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)``.

Tolerances, float32: logits and loss atol 2e-5 (the summation order of
matmuls, softmax and norms differs); gradients atol 2e-5 + rtol 1e-3
(each is a sum over all B*S tokens).  Remat policies recompute the same
operations in the same order: equal to 1e-6.  AdamW on identical
gradients: atol 1e-7 + rtol 1e-6 (torch decays the parameter before
adding the step, optax adds both in one update: one f32 rounding
apart).  AdamW on each side's own gradients: Adam's
first steps are ~sign(g) * lr, so a gradient entry that is ~0 on both
sides may round to opposite signs; the parameters are held to atol
2e-5 + 0.5 % of entries within 2 * lr * steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.distributed import HybridTopology
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama

CONFIGS = {
    # name: (config fields, B, S)
    "llama-debug": (dict(jllama.PRESETS["llama-debug"]), 2, 32),
    "bench-cpu-smoke": (dict(vocab_size=1024, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=4,
                             num_attention_heads=4, num_key_value_heads=4,
                             max_position_embeddings=512), 2, 256),
}


def _cfgs(fields, **port):
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, use_remat=False,
                              fused_blocks="off", **fields)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **{
        "use_remat": False, **port, **fields})
    return jcfg, tcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _port_params(np_params):
    params = convert.params_from_jax(np_params, device="cpu")
    for t in _flat(params).values():
        t.requires_grad_(True)
    return params


def _port_step(tcfg, params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = tllama.forward_pure(tcfg, params, tb["input_ids"])
    total, ce = tllama.loss_fn(tcfg, params, tb)
    total.backward()
    return logits.detach(), total.item(), ce.item()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_and_grads_match_jax(name):
    fields, B, S = CONFIGS[name]
    jcfg, tcfg = _cfgs(fields)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab_size, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(lambda p: jllama.forward_pure(
        jcfg, p, jb["input_ids"]))(jparams)
    (jtotal, jce), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True))(jparams)

    params = _port_params(_np(jparams))
    logits, total, ce = _port_step(tcfg, params, batch)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    assert abs(total - float(jtotal)) <= 2e-5
    assert abs(ce - float(jce)) <= 2e-5
    ref = _flat(_np(jgrads))
    got = _flat(params)
    assert sorted(got) == sorted(ref)
    for n, g in ref.items():
        np.testing.assert_allclose(got[n].grad.numpy(), g, atol=2e-5,
                                   rtol=1e-3, err_msg=n)


def _grads_under(policy):
    fields, B, S = CONFIGS["llama-debug"]
    port = ({"use_remat": False} if policy == "none"
            else {"use_remat": True, "remat_policy": policy})
    jcfg, tcfg = _cfgs(fields, **port)
    params = _port_params(_np(jllama.init_params(jcfg,
                                                 jax.random.PRNGKey(1))))
    _, total, _ = _port_step(tcfg, params, _batch(jcfg.vocab_size, B, S))
    return total, {n: t.grad for n, t in _flat(params).items()}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_grads(policy):
    total0, ref = _grads_under("none")
    total, got = _grads_under(policy)
    assert abs(total - total0) <= 1e-6
    for n, g in ref.items():
        torch.testing.assert_close(got[n], g, atol=1e-6, rtol=0, msg=n)


def test_adamw_matches_optax_on_the_same_grads():
    rng = np.random.default_rng(3)
    shapes = {"embed": (16, 8), "layers": {"wq": (2, 8, 8), "ln1": (2, 8)},
              "norm_f": (8,)}
    np_params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * 1e-2).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    opt = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = opt.init(jp)
    params = convert.params_from_jax(np_params, device="cpu")
    leaves = tbench.leaves(params)
    topt = tbench.make_optimizer(params)
    for g in grads:
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, gg in zip(leaves, tbench.leaves(
                convert.params_from_jax(g, device="cpu"))):
            t.grad = gg
        topt.step()
    for n, r in _flat(_np(jp)).items():
        np.testing.assert_allclose(_flat(params)[n].detach().numpy(), r,
                                   atol=1e-7, rtol=1e-6, err_msg=n)


def test_three_bench_steps_match_optax():
    fields, B, S = CONFIGS["llama-debug"]
    jcfg, tcfg = _cfgs(fields, use_remat=True, remat_policy="dots")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    batch = _batch(jcfg.vocab_size, B, S, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    state = opt.init(jparams)
    params = _port_params(_np(jparams))
    topt = tbench.make_optimizer(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    steps = 3

    @jax.jit
    def jstep(p, state):
        (_, jce), g = jax.value_and_grad(
            lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True)(p)
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state, jce

    for _ in range(steps):
        jparams, state, jce = jstep(jparams, state)
        ce = tbench.train_step(tcfg, params, topt, tb)
        assert abs(ce.item() - float(jce)) <= 2e-5
    flips = total = 0
    for n, r in _flat(_np(jparams)).items():
        d = np.abs(_flat(params)[n].detach().numpy() - r)
        assert d.max() <= 2 * 3e-4 * steps, n
        flips += int((d > 2e-5).sum())
        total += d.size
    assert flips <= 0.005 * total, (flips, total)


def test_bench_cpu_smoke_prints_one_json_line(capsys):
    rc = tbench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    import json
    res = json.loads(out[0])
    assert res["value"] is None and "not a card" in res["mfu_note"]
    assert res["attention"] == "plain_cpu" and res["remat_policy"] == "none"
    assert res["fused_blocks"] == {"attention": False, "mlp": False}
    assert set(res["launches_per_step"].values()) == {0}
    assert (res["batch"], res["seq"]) == (2, 256)
    assert np.isfinite(res["loss_step0"])
    assert abs(res["loss_step0"] - np.log(1024)) <= 0.5


def test_mfu_peak_table():
    assert tbench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert tbench.peak_bf16_flops("NVIDIA A100-SXM4-80GB") is None
    cfg = tllama.LlamaConfig(**tbench.MODEL)
    # bench.py's shape: 953,223,168 parameters (embed, lm_head, norm_f
    # and 16 layers of 4 H x H, 3 H x I and 2 norms)
    H, I = cfg.hidden_size, cfg.intermediate_size
    n = 2 * cfg.vocab_size * H + H + 16 * (4 * H * H + 3 * H * I + 2 * H)
    assert n == 953_223_168
    assert tbench.model_flops(953_223_168, 4, 2048, cfg) == pytest.approx(
        6 * 953_223_168 * 8192 + 6 * 4 * 2048 ** 2 * 2048 * 16)


def test_unported_branches_raise():
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.LlamaConfig(remat_policy="everything")
    fields, B, S = CONFIGS["llama-debug"]
    _, tcfg = _cfgs(fields)
    params = tllama.init_params(tcfg, 0, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    # sequence parallelism over mp is ported: on one rank it changes
    # nothing, as in the reference on one device
    torch.testing.assert_close(
        tllama.forward_pure(tcfg, params, ids, sp_axis="mp"),
        tllama.forward_pure(tcfg, params, ids), atol=0, rtol=0)
    # context parallelism comes from the topology's sp degree: on one
    # rank (sp = 1) it changes nothing; sp_axis is only ever "mp"
    with pytest.raises(ValueError, match="sp_axis"):
        tllama.forward_pure(tcfg, params, ids, sp_axis="sp")
    torch.testing.assert_close(
        tllama.forward_pure(tcfg, params, ids, cp_mesh=HybridTopology()),
        tllama.forward_pure(tcfg, params, ids), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the fused decoder blocks (fused_blocks="on" on both sides; the JAX side
# runs its Pallas kernels in interpret mode)
# ---------------------------------------------------------------------------
# A 2-layer config with head dim 128 and nkv == nh, so that both fused
# blocks engage, at fused_parity_cases' widths (H = 256, I = 512).
# Tolerances as above: logits and loss atol 2e-5, gradients atol 2e-5 +
# rtol 1e-3 (float32); "on" against "off" in the port, whose f32 sums
# run in another order, atol 2e-5 and gradients atol 2e-5 + rtol 1e-3.

FUSED = (dict(vocab_size=256, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=256), 1, 256)


@pytest.fixture
def interpret():
    from paddle_tpu.ops import pallas_ops
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _fused_cfgs(mode, **port):
    fields, _, _ = FUSED
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, use_remat=False,
                              fused_blocks=mode, **fields)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, fused_blocks=mode,
                              **{"use_remat": False, **port, **fields})
    return jcfg, tcfg


def test_fused_loss_and_grads_match_jax(interpret):
    _, B, S = FUSED
    jcfg, tcfg = _fused_cfgs("on")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    batch = _batch(jcfg.vocab_size, B, S, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x = jnp.zeros((B, S, jcfg.hidden_size), jnp.float32)
    assert jllama._fused_block_modes(jcfg, x, None, False) == (True, True)
    jlogits, _ = jllama.forward_pure(jcfg, jparams, jb["input_ids"])
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True)(jparams)

    params = _port_params(_np(jparams))
    assert tllama._fused_block_modes(tcfg, torch.zeros(1)) == (True, True)
    logits, total, _ = _port_step(tcfg, params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    assert abs(total - float(jtotal)) <= 2e-5
    ref = _flat(_np(jgrads))
    for n, g in ref.items():
        np.testing.assert_allclose(_flat(params)[n].grad.numpy(), g,
                                   atol=2e-5, rtol=1e-3, err_msg=n)


def test_fused_decoder_layer_matches_jax(interpret):
    """One decoder layer at "on", output and the gradient of the input
    and of every layer weight, against the reference's layer."""
    fields, B, S = FUSED
    jcfg, tcfg = _fused_cfgs("on")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(6))
    jlp = {k: v[0] for k, v in jparams["layers"].items()}
    x = (np.random.RandomState(6).standard_normal(
        (B, S, fields["hidden_size"])) * 0.5).astype(np.float32)
    dy = (np.random.RandomState(7).standard_normal(x.shape)
          ).astype(np.float32)
    jsin, jcos = jllama._rope_tables(jcfg, S)

    def jlayer(xx, lp):
        return jllama.decoder_layer(jcfg, lp, xx, jsin, jcos)[0]

    y_r, pull = jax.vjp(jlayer, jnp.asarray(x), jlp)
    dx_r, dlp_r = pull(jnp.asarray(dy))
    lp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jlp.items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    sin, cos = tllama._rope_tables(tcfg, S, "cpu")
    y, _ = tllama.decoder_layer(tcfg, lp, xx, sin, cos)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(dx_r),
                               atol=2e-5, rtol=1e-3)
    for n, g in dlp_r.items():
        np.testing.assert_allclose(lp[n].grad.numpy(), np.asarray(g),
                                   atol=2e-5, rtol=1e-3, err_msg=n)


def test_fused_on_matches_off_in_the_port():
    """The counterpart of test_pallas_fused's
    test_decoder_layer_fused_matches_unfused, over the whole loss."""
    _, B, S = FUSED
    jcfg, on = _fused_cfgs("on")
    _, off = _fused_cfgs("off")
    np_params = _np(jllama.init_params(jcfg, jax.random.PRNGKey(8)))
    batch = _batch(jcfg.vocab_size, B, S, seed=8)
    outs = []
    for cfg in (on, off):
        params = _port_params(np_params)
        logits, total, _ = _port_step(cfg, params, batch)
        outs.append((logits, total, {n: t.grad for n, t in
                                     _flat(params).items()}))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=2e-5, rtol=0)
    assert abs(outs[0][1] - outs[1][1]) <= 2e-5
    for n, g in outs[1][2].items():
        torch.testing.assert_close(outs[0][2][n], g, atol=2e-5, rtol=1e-3,
                                   msg=n)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_fused_remat_policies_give_the_same_grads(policy):
    _, B, S = FUSED
    jcfg, ref_cfg = _fused_cfgs("on")
    _, cfg = _fused_cfgs("on", use_remat=True, remat_policy=policy)
    np_params = _np(jllama.init_params(jcfg, jax.random.PRNGKey(9)))
    batch = _batch(jcfg.vocab_size, B, S, seed=9)
    got = []
    for c in (ref_cfg, cfg):
        params = _port_params(np_params)
        _, total, _ = _port_step(c, params, batch)
        got.append((total, {n: t.grad for n, t in _flat(params).items()}))
    assert abs(got[0][0] - got[1][0]) <= 1e-6
    for n, g in got[0][1].items():
        torch.testing.assert_close(got[1][1][n], g, atol=1e-6, rtol=0,
                                   msg=n)


def test_fused_block_policy():
    """None and "auto" stay unfused on the CPU; "on" engages on any
    device; GQA keeps the unfused attention with the fused MLP; a head
    dim the flash kernels do not take keeps the unfused attention;
    quantized leaves and "off" stay unfused; a bad value raises."""
    fields, _, _ = FUSED
    x = torch.zeros((1, 4, fields["hidden_size"]))
    for mode in (None, "auto", "off"):
        cfg = tllama.LlamaConfig(fused_blocks=mode, **fields)
        assert tllama._fused_block_modes(cfg, x) == (False, False)
    on = tllama.LlamaConfig(fused_blocks="on", **fields)
    assert tllama._fused_block_modes(on, x) == (True, True)
    assert tllama._fused_block_modes(on, x.to("meta")) == (True, True)
    gqa = tllama.LlamaConfig(fused_blocks="on",
                             **{**fields, "num_key_value_heads": 1})
    assert tllama._fused_block_modes(gqa, x) == (False, True)
    d32 = tllama.LlamaConfig(fused_blocks="on",
                             **{**fields, "num_attention_heads": 8,
                                "num_key_value_heads": 8})
    assert tllama._fused_block_modes(d32, x) == (False, True)
    with pytest.raises(ValueError, match="fused_blocks"):
        tllama.LlamaConfig(fused_blocks="always")


def test_fused_policy_routes_each_layer(monkeypatch):
    """decoder_layer calls the fused blocks exactly where the policy
    engages them: both at "on"; the MLP alone under GQA; neither with
    int8 leaves (quantize_params) or at "off"."""
    from paddle_tpu_torch.ops import fused_blocks as fb
    calls = []
    for name in ("fused_attention_block", "fused_mlp_block"):
        real = getattr(fb, name)
        monkeypatch.setattr(fb, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    fields, _, S = FUSED
    S = 16
    for nkv, mode, quant, want in (
            (2, "on", False, ["fused_attention_block", "fused_mlp_block"]),
            (1, "on", False, ["fused_mlp_block"]),
            (2, "on", True, []),
            (2, "off", False, [])):
        cfg = tllama.LlamaConfig(dtype=torch.float32, fused_blocks=mode,
                                 **{**fields, "num_key_value_heads": nkv})
        params = tllama.init_params(cfg, 0, device="cpu")
        if quant:
            params = tllama.quantize_params(cfg, params)
        lp = {k: tllama._layer(v, 0) for k, v in params["layers"].items()}
        sin, cos = tllama._rope_tables(cfg, S, "cpu")
        calls.clear()
        y, _ = tllama.decoder_layer(cfg, lp, torch.zeros(
            (1, S, fields["hidden_size"])), sin, cos)
        assert calls == want, (nkv, mode, quant)
        assert torch.isfinite(y).all()
