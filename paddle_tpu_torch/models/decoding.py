"""Autoregressive decoding with a dense KV cache (the port of
``paddle_tpu/models/decoding.py``), shared by the Llama and GPT
families.

The cache is a stacked ``[L, B, S_max, kv_heads, head_dim]`` pair on the
model's device, written in place a chunk at a time (the reference returns
new arrays; JAX's are immutable).  ``cached_attention_core`` attends a
chunk's queries over one layer's cache in f32, plain PyTorch, as the
reference's is plain jnp: no TPU kernel sits under it, so there is no
kernel to port.  Prefill is the prompt as one chunk (``T`` = prompt
length), decode one token a step, through the same function.

The reference's decode loop is one ``lax.scan`` that never leaves the
device.  Here it is a Python loop over device tensors with no host sync
inside it: sampling, ``finished`` and the eos fill are tensor ops, no
``.item()``, no early exit, exactly ``max_new_tokens - 1`` steps after
the prefill, as the scan.  The reference's ``_RUN_CACHE`` memoises
compiled JAX programs per signature; eager PyTorch has nothing to
compile, so it has no counterpart.

Sampling draws from one explicit ``torch.Generator`` on the model's
device (seeded from ``rng`` / ``seed``), by the Gumbel-max trick as
``jax.random.categorical`` samples; the bits differ from JAX's keys, so
sampled tokens are held to their law, and greedy decoding to JAX's
tokens exactly.  Tokens are int64 (torch's index type; the reference's
are int32).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device

__all__ = ["KVCache", "init_kv_cache", "cached_attention_core",
           "sample_logits", "generate_tokens", "GenerationMixin",
           "model_generate"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, n_kv_heads, head_dim]
    v: torch.Tensor


def init_kv_cache(num_layers, batch, max_len, n_kv_heads, head_dim,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """A zeroed cache on ``device`` (the card unless the caller names
    another)."""
    dev = resolve_device(device)
    shape = (num_layers, batch, max_len, n_kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


_NEG_BIG = -1e30  # finite mask: -inf would NaN a fully-masked row


def cached_attention_core(q, k_new, v_new, cache_k, cache_v, pos: int,
                          lengths=None):
    """q/k_new/v_new: [B, T, h, d] (k/v at kv-head width) for the chunk
    starting at position ``pos``; cache_k/v: [B, S_max, kv_h, d] of one
    layer, UPDATED IN PLACE with the chunk's k/v at ``pos``.  Returns
    (out [B, T, h, d] in q's dtype, cache_k, cache_v).

    GQA: q is viewed as [B, T, kv_h, rep, d] and contracted against the
    kv-width cache, so q head h reads kv head h // rep and K/V are never
    expanded.  ``lengths`` ([B] ints, optional): the valid kv length of
    each row including the chunk, default ``pos + T``; cache positions
    at or past it are masked explicitly, whatever the cache holds
    there, as is every key after its query (causal)."""
    B, T, nh, d = q.shape
    S_max, nkv = cache_k.shape[1], cache_k.shape[2]
    cache_k[:, pos:pos + T] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + T] = v_new.to(cache_v.dtype)
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    q_pos = pos + torch.arange(T, device=dev)
    key_pos = torch.arange(S_max, device=dev)
    kv_len = (torch.full((B,), pos + T, device=dev) if lengths is None
              else torch.as_tensor(lengths, device=dev).reshape(-1)
              .expand(B))
    mask = ((key_pos[None, None, :] <= q_pos[None, :, None])
            & (key_pos[None, None, :] < kv_len[:, None, None]))
    rep = nh // nkv
    qg = q.reshape(B, T, nkv, rep, d).float()
    logits = torch.einsum("btkrd,bskd->bkrts", qg, cache_k.float()) * scale
    logits = torch.where(mask[:, None, None], logits, _NEG_BIG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrts,bskd->btkrd", probs, cache_v.float())
    return out.reshape(B, T, nh, d).to(q.dtype), cache_k, cache_v


def sample_logits(logits, temperature: float, top_k: int,
                  generator: Optional[torch.Generator] = None):
    """logits [B, V] f32 -> tokens [B] (int64).  ``temperature`` 0:
    greedy (argmax); else softmax(logits / temperature) sampled with the
    Gumbel-max trick from ``generator``, over the ``top_k`` largest
    logits when ``top_k`` > 0 (ties at the k-th value stay in)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _generator(rng, device) -> torch.Generator:
    """``rng``: a ``torch.Generator`` (used as is) or an int seed (None:
    0) for a new one on ``device``."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng or 0))
    return gen


@torch.no_grad()
def generate_tokens(forward_with_cache: Callable, params, input_ids,
                    cache: KVCache, max_new_tokens: int,
                    temperature: float = 0.0, top_k: int = 0, rng=None,
                    eos_token_id: Optional[int] = None):
    """The shared generate loop: prefill the prompt, then one token a
    step.  ``forward_with_cache(params, tokens [B, T], cache, pos) ->
    (logits [B, T, V] f32, cache)``.  Returns [B, max_new_tokens]
    int64; after a row's eos every position holds eos.  ``rng``: a
    ``torch.Generator`` on the cache's device or an int seed."""
    dev = cache.k.device
    gen = _generator(rng, dev)
    ids = torch.as_tensor(input_ids).to(dev).long()
    P = ids.shape[1]
    logits, cache = forward_with_cache(params, ids, cache, 0)
    tok = sample_logits(logits[:, -1], temperature, top_k, gen)
    finished = None
    if eos_token_id is not None:
        finished = tok == eos_token_id
    out = [tok]
    for step in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, tok[:, None], cache,
                                           P + step)
        nxt = sample_logits(logits[:, 0], temperature, top_k, gen)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


class GenerationMixin:
    """``generate()`` for an eager model class: set ``_generate_fn`` to
    the family's functional generate ``(cfg, params, ids, n, ...)`` and
    give the class ``config`` and ``_tree()``.  Returns a ``Tensor`` of
    int64 tokens."""

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, seed=0, eos_token_id=None):
        from ..core.tensor import Tensor
        if isinstance(input_ids, Tensor):
            input_ids = input_ids._t
        fn = type(self)._generate_fn
        return Tensor._wrap(fn(self.config, self._tree(), input_ids,
                               max_new_tokens, temperature=temperature,
                               top_k=top_k, rng=seed,
                               eos_token_id=eos_token_id))


def model_generate(forward_with_cache: Callable, *, num_layers: int,
                   kv_heads: int, head_dim: int, max_positions: int,
                   cache_dtype, device, params, input_ids,
                   max_new_tokens: int, temperature: float = 0.0,
                   top_k: int = 0, rng=None,
                   eos_token_id: Optional[int] = None):
    """The one generate() wrapper every model family shares: the bound
    check against the positional budget, the cache at kv-head width on
    ``device`` (the params'), the loop."""
    input_ids = torch.as_tensor(input_ids)
    B, P = input_ids.shape
    max_len = P + max_new_tokens
    if max_len > max_positions:
        raise ValueError(
            f"prompt {P} + max_new_tokens {max_new_tokens} exceeds "
            f"max_position_embeddings {max_positions}")
    cache = init_kv_cache(num_layers, B, max_len, kv_heads, head_dim,
                          dtype=cache_dtype, device=device)
    return generate_tokens(forward_with_cache, params, input_ids, cache,
                           max_new_tokens, temperature=temperature,
                           top_k=top_k, rng=rng, eos_token_id=eos_token_id)
