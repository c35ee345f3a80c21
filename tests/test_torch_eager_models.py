"""The model families' eager classes as ``Layer``s, trained the Paddle way
on the CPU, against the JAX package's eager run.

Tiny f32 ``LlamaForCausalLM`` (dense and GQA) and ``GPTForCausalLM``:
their ``state_dict`` keys equal the reference's; the port takes the JAX
model's weights through ``set_state_dict``; both run 3 steps of
``loss.backward(); AdamW(LinearWarmup, ClipGradByGlobalNorm).step();
clear_grad()`` on the same batch.  Losses agree to 1e-4 at every step
and the parameters after the 3 steps to 1e-4 (AdamW's first steps move
each weight by about lr whatever its gradient's size, so the check is
tight against lr = 1e-3).  Greedy ``generate`` returns a ``Tensor``
equal to JAX's token for token.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=64)
GPT = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _models(family, **over):
    if family == "gpt":
        fields = dict(GPT, **over)
        return (jgpt.GPTForCausalLM(jgpt.GPTConfig(dtype=jnp.float32,
                                                   **fields)),
                tgpt.GPTForCausalLM(tgpt.GPTConfig(dtype=torch.float32,
                                                   **fields)))
    fields = dict(LLAMA, **over)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(
        dtype=jnp.float32, use_remat=False, fused_blocks="off", **fields))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(
        dtype=torch.float32, use_remat=False, **fields))
    return jm, tm


def _batch(vocab, seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _train(paddle, model, ids, labels, steps=3):
    sched = paddle.optimizer.lr.LinearWarmup(1e-3, 2, 1e-4, 1e-3)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    losses = []
    for _ in range(steps):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}


CASES = [("llama", {}), ("llama", dict(num_key_value_heads=2)),
         ("gpt", {})]


@pytest.mark.parametrize("family,over", CASES,
                         ids=["llama-dense", "llama-gqa", "gpt"])
def test_eager_adamw_steps_match_the_reference(family, over):
    jm, tm = _models(family, **over)
    assert isinstance(tm, tpaddle.nn.Layer)
    assert list(tm.state_dict()) == list(jm.state_dict())
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    params = tm.parameters()
    assert all(isinstance(p, tpaddle.nn.Parameter) and p.is_leaf
               for p in params)
    ids, labels = _batch(tm.config.vocab_size)
    jl, jsd = _train(jpaddle, jm, ids, labels)
    tl, tsd = _train(tpaddle, tm, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tl[-1] < tl[0]
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # the optimizer wrote into the parameters' own storage
    assert [p._t for p in tm.parameters()] == [p._t for p in params]


@pytest.mark.parametrize("family,over", CASES,
                         ids=["llama-dense", "llama-gqa", "gpt"])
def test_generate_returns_a_tensor_equal_to_the_reference(family, over):
    jm, tm = _models(family, **over)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    ids, _ = _batch(tm.config.vocab_size, seed=4, S=5)
    out = tm.generate(ids, 6)
    assert isinstance(out, tpaddle.Tensor) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jm.generate(ids, 6)._array))
    # a Tensor prompt too
    np.testing.assert_array_equal(
        tm.generate(tpaddle.to_tensor(ids), 6).numpy(), out.numpy())


def test_llama_eager_loss_is_forward_pure_then_the_references_ce():
    """The eager forward adds no cast, copy or detach: its loss and every
    gradient equal ``torch.autograd.grad`` of forward_pure followed by
    the cross-entropy composition on the raw tensors, bit for bit."""
    from paddle_tpu_torch.nn.functional.loss import cross_entropy_raw
    _, tm = _models("llama", num_key_value_heads=2)
    ids, labels = _batch(tm.config.vocab_size, seed=2)
    loss, _ = tm(ids, labels=labels)
    loss.backward()
    raw = [p._t.detach().clone().requires_grad_(True)
           for p in tm.parameters()]
    tree = tllama._unflatten_params(dict(zip(tm._names, raw)))
    logits, _ = tllama.forward_pure(tm.config, tree, torch.from_numpy(ids))
    V = logits.shape[-1]
    ref = cross_entropy_raw(logits.reshape(-1, V),
                            torch.from_numpy(labels).reshape(-1))
    grads = torch.autograd.grad(ref, raw)
    assert torch.equal(loss._t, ref)
    for p, g in zip(tm.parameters(), grads):
        assert torch.equal(p.grad._t, g), p.name
