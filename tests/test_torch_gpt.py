"""The port's GPT-2 family (``paddle_tpu_torch/models/gpt.py``) against
the JAX reference on the CPU.

Weights are drawn by JAX (``gpt.init_params``) and cross with
``params_from_jax``; batches come from numpy seeds.  The JAX side sends
head dim 16 / 64 to its jnp attention; the port's ``causal_attention``
runs its plain version on CPU tensors (on the card: the flash kernels).

Tolerances.  float32: logits atol 1e-4, loss atol 1e-5, each gradient
leaf max |diff| <= 1e-4 x max |ref| (a gradient is a sum over every
token).  bfloat16: logits, loss and each gradient leaf within 2e-2 x
max |ref| (the reference's bf16 attention scores its logits in bf16,
the port's plain version in f32; both round the output to bf16).
Remat recomputes the same operations: loss and gradients equal to
1e-6.  Greedy tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=64)
# GPT-2 small's head dim (64) at a tiny width
D64 = dict(FIELDS, hidden_size=128, num_attention_heads=2)


def _cfgs(fields=FIELDS, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    return (jgpt.GPTConfig(dtype=jdtype, **fields),
            tgpt.GPTConfig(dtype=tdtype, **fields, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(jcfg, seed=0):
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(_np(jp), device="cpu")
    for t in tllama._paths(tp).values():
        t.requires_grad_(True)
    return jp, tp


def _batch(B=2, S=16, seed=0, vocab=FIELDS["vocab_size"]):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(
        np.abs(ref).max(), 1e-12)


def _jax_loss_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.value_and_grad(lambda p: jgpt.loss_fn(jcfg, p, jb))(jp)
    return float(loss), {k: _f32(v) for k, v in tllama._paths(g).items()}


def _port_loss_grads(tcfg, tp, batch):
    loss = tgpt.loss_fn(tcfg, tp, batch)
    loss.backward()
    grads = {k: t.grad.float().numpy() for k, t in tllama._paths(tp).items()}
    for t in tllama._paths(tp).values():
        t.grad = None
    return loss.item(), grads


@pytest.mark.parametrize("fields", [FIELDS, D64], ids=["d16", "d64"])
def test_forward_pure_matches_jax(fields):
    jcfg, tcfg = _cfgs(fields)
    jp, tp = _params(jcfg)
    ids = _batch()["input_ids"]
    ref = np.asarray(jgpt.forward_pure(jcfg, jp, jnp.asarray(ids)))
    got = tgpt.forward_pure(tcfg, tp, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 96)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fields", [FIELDS, D64], ids=["d16", "d64"])
def test_loss_and_every_gradient_match_jax_f32(fields):
    jcfg, tcfg = _cfgs(fields)
    jp, tp = _params(jcfg, seed=1)
    batch = _batch(seed=1)
    ref_loss, ref_g = _jax_loss_grads(jcfg, jp, batch)
    loss, grads = _port_loss_grads(tcfg, tp, batch)
    assert abs(loss - ref_loss) <= 1e-5
    assert set(grads) == set(ref_g)
    for k in ref_g:
        assert _rel(grads[k], ref_g[k]) <= 1e-4, k


def test_loss_logits_and_gradients_match_jax_bf16():
    jcfg, tcfg = _cfgs(D64, jnp.bfloat16, torch.bfloat16)
    jp, tp = _params(jcfg, seed=2)
    batch = _batch(seed=2)
    ref = np.asarray(jgpt.forward_pure(jcfg, jp,
                                       jnp.asarray(batch["input_ids"])))
    got = tgpt.forward_pure(tcfg, tp, torch.from_numpy(batch["input_ids"]))
    assert _rel(got.detach().numpy(), ref) <= 2e-2
    ref_loss, ref_g = _jax_loss_grads(jcfg, jp, batch)
    loss, grads = _port_loss_grads(tcfg, tp, batch)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
    for k in ref_g:
        assert _rel(grads[k], ref_g[k]) <= 2e-2, k


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_gives_the_same_loss_and_gradients(policy):
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=3)
    batch = _batch(seed=3)
    loss, grads = _port_loss_grads(tcfg, tp, batch)
    _, rcfg = _cfgs(use_remat=True, remat_policy=policy)
    rloss, rgrads = _port_loss_grads(rcfg, tp, batch)
    assert abs(rloss - loss) <= 1e-6
    for k in grads:
        np.testing.assert_allclose(rgrads[k], grads[k], atol=1e-6, rtol=0)


def test_tied_head_gradient_accumulates_on_wte():
    """The head is ``wte.T``: its gradient and the embedding's land on the
    one tensor, as JAX's sum of both uses."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    batch = _batch(seed=4)
    _, ref_g = _jax_loss_grads(jcfg, jp, batch)
    _, grads = _port_loss_grads(tcfg, tp, batch)
    assert _rel(grads["wte"], ref_g["wte"]) <= 1e-4
    # rows of tokens the batch never names still get the head's gradient
    unused = sorted(set(range(96)) - set(batch["input_ids"].ravel()))
    assert np.abs(grads["wte"][unused]).max() > 0


@pytest.mark.parametrize("fields", [FIELDS, D64], ids=["d16", "d64"])
def test_greedy_generate_matches_jax(fields):
    jcfg, tcfg = _cfgs(fields)
    jp, tp = _params(jcfg, seed=5)
    ids = _batch(B=3, S=5, seed=5)["input_ids"]
    ref = np.asarray(jgpt.generate(jcfg, jp, jnp.asarray(ids), 7))
    got = tgpt.generate(tcfg, tp, ids, 7)
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="exceeds"):
        tgpt.generate(tcfg, tp, ids, 60)


def test_cached_forward_matches_forward_pure():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=6)
    ids = torch.from_numpy(_batch(S=9, seed=6)["input_ids"])
    with torch.no_grad():
        cache = tgpt.decoding.init_kv_cache(2, 2, 12, 4, 16, torch.float32,
                                            "cpu")
        got, _ = tgpt.forward_with_cache(tcfg, tp, ids[:, :6], cache, 0)
        step, _ = tgpt.forward_with_cache(tcfg, tp, ids[:, 6:9], cache, 6)
        full = tgpt.forward_pure(tcfg, tp, ids)
    np.testing.assert_allclose(torch.cat([got, step], 1).numpy(),
                               full.numpy(), atol=1e-5)


def test_gpt_for_causal_lm_matches_the_reference_facade():
    import paddle_tpu_torch as tpaddle
    tpaddle.set_device("cpu")
    jcfg, tcfg = _cfgs()
    jm = jgpt.GPTForCausalLM(jcfg)
    tm = tgpt.GPTForCausalLM(tcfg)
    jsd = jm.state_dict()
    assert list(tm.state_dict()) == list(jsd)
    tm.set_state_dict({k: np.asarray(v._array) for k, v in jsd.items()})
    b = _batch(seed=7)
    jloss, jlogits = jm(b["input_ids"], labels=b["labels"])
    loss, logits = tm(b["input_ids"], labels=torch.from_numpy(b["labels"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._array),
                               atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(np.asarray(jloss._array)),
                               atol=1e-5)
    assert abs(loss.item() - tgpt.loss_fn(tcfg, tm._tree(), b).item()) \
        <= 1e-6
    loss.backward()
    assert tm.wte.grad is not None and tm.wte.grad.abs().max().item() > 0
    np.testing.assert_array_equal(
        tm.generate(b["input_ids"][:, :4], 5).numpy(),
        np.asarray(jm.generate(b["input_ids"][:, :4], 5)._array))


def test_init_params_layout_and_residual_scale():
    cfg = tgpt.GPTConfig(dtype=torch.float32, vocab_size=64, hidden_size=32,
                         num_hidden_layers=8, num_attention_heads=2,
                         max_position_embeddings=16)
    p = tgpt.init_params(cfg, 0, device="cpu")
    ref = jgpt.init_params(jgpt.GPTConfig(
        dtype=jnp.float32, vocab_size=64, hidden_size=32, num_hidden_layers=8,
        num_attention_heads=2, max_position_embeddings=16),
        jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in tllama._paths(p).items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in tllama._paths(_np(ref)).items()}
    # GPT-2's init: the residual projections at 1/sqrt(2L) of the others
    ratio = (p["layers"]["proj_w"].std() / p["layers"]["attn_w"].std()).item()
    assert abs(ratio - 0.25) < 0.02
    assert cfg.intermediate_size == 128
    assert torch.equal(tgpt.init_params(cfg, 0, device="cpu")["wte"],
                       p["wte"])
