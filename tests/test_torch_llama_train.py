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
    logits = tllama.forward_pure(tcfg, params, tb["input_ids"])
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
    with pytest.raises(NotImplementedError, match="A.6"):
        tllama.forward_pure(tcfg, params, ids, sp_axis="sp")
    with pytest.raises(NotImplementedError, match="A.6"):
        tllama.forward_pure(tcfg, params, ids, cp_mesh=object())
    moe = tllama.LlamaConfig(dtype=torch.float32,
                             **{**fields, "moe_num_experts": 2})
    x = torch.zeros((1, 4, fields["hidden_size"]))
    lp = {k: v[0] for k, v in params["layers"].items()}
    sin, cos = tllama._rope_tables(tcfg, 4, "cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        tllama.decoder_layer(moe, lp, x, sin, cos)
