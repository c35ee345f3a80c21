"""GPT-2-style decoder family (the port of ``paddle_tpu/models/gpt.py``):
pre-LN blocks, learned positional embeddings, fused-QKV projection,
GELU MLP, tied LM head.

Same functional design as ``models/llama.py``: a stacked ``[L, ...]``
parameter dict, the layers in a Python loop (the reference's
``lax.scan``), remat per layer, KV-cache generation through
``models/decoding.py``.

- Attention is the port's ``causal_attention``: on a CUDA tensor the
  hand-written flash kernels (``flash_fwd`` / ``flash_bwd``, bf16, head
  dim 64 or 128: GPT-2 small's 12 heads of 64 take them), on a CPU
  tensor their plain version.  The reference sends D = 64 to its jnp
  path (its Pallas kernel wants D % 128 == 0), the same function.  A
  float32 model on the card raises in the kernel's argument check, as
  the Llama does: there is no quiet route to the plain version.
- GELU is the tanh form (``jax.nn.gelu``'s default), the variance the
  population one (``jnp.var``), and ``_ln`` normalises in f32, casts to
  the activation dtype, then scales: the reference's order, which bf16
  parity depends on.
- ``forward_with_cache`` attends through the plain
  ``cached_attention_core``, never flash, so ``generate`` runs in
  either dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.flash_attention import causal_attention
from . import decoding
from ..core.place import current_device
from .llama import _StackedLayer, _dots_context

__all__ = ["GPTConfig", "init_params", "forward_pure", "loss_fn",
           "forward_with_cache", "generate", "GPTForCausalLM"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0          # 0 -> 4 * hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16
    use_remat: bool = False
    remat_policy: str = "dots"

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} does not split "
                             f"into {self.num_attention_heads} heads")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def init_params(cfg: GPTConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Stacked parameter dict drawn N(0, 0.02) in f32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless the caller names another), then cast; the residual-path
    projections (``proj_w``, ``fcp_w``) scaled by 1/sqrt(2L) (GPT-2's
    init)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    std = 0.02
    res = 1.0 / (2 * L) ** 0.5

    def init(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std * scale).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    return {
        "wte": init((cfg.vocab_size, H)),
        "wpe": init((cfg.max_position_embeddings, H)),
        "layers": {
            "ln1_g": ones((L, H)), "ln1_b": zeros((L, H)),
            "attn_w": init((L, H, 3 * H)), "attn_b": zeros((L, 3 * H)),
            "proj_w": init((L, H, H), res), "proj_b": zeros((L, H)),
            "ln2_g": ones((L, H)), "ln2_b": zeros((L, H)),
            "fc_w": init((L, H, I)), "fc_b": zeros((L, I)),
            "fcp_w": init((L, I, H), res), "fcp_b": zeros((L, H)),
        },
        "lnf_g": ones((H,)),
        "lnf_b": zeros((H,)),
    }


def _ln(x, g, b, eps):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _qkv(cfg: GPTConfig, lp, xn):
    B, T, _ = xn.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    q, k, v = (xn @ lp["attn_w"] + lp["attn_b"]).chunk(3, dim=-1)
    return (q.reshape(B, T, nh, d), k.reshape(B, T, nh, d),
            v.reshape(B, T, nh, d))


def _mlp(lp, hn):
    return _gelu(hn @ lp["fc_w"] + lp["fc_b"]) @ lp["fcp_w"] + lp["fcp_b"]


def _block(cfg: GPTConfig, lp, x):
    eps = cfg.layer_norm_epsilon
    B, T, H = x.shape
    q, k, v = _qkv(cfg, lp, _ln(x, lp["ln1_g"], lp["ln1_b"], eps))
    att = causal_attention(q, k, v).reshape(B, T, H)
    x = x + att @ lp["proj_w"] + lp["proj_b"]
    return x + _mlp(lp, _ln(x, lp["ln2_g"], lp["ln2_b"], eps))


def _embed(params, ids, pos0: int = 0):
    wte = params["wte"]
    ids = ids.to(wte.device).long()
    pos = torch.arange(pos0, pos0 + ids.shape[1], device=wte.device)
    return wte[ids] + params["wpe"][pos][None]


def forward_pure(cfg: GPTConfig, params, input_ids):
    """ids [B, S] -> logits [B, S, V] f32 (the head tied to ``wte``), on
    the params' device.  ``use_remat``: each block under
    ``torch.utils.checkpoint``, ``remat_policy`` "dots" saving the
    matmul outputs (``jax.checkpoint_policies.dots_saveable``), "full"
    only the block's input; the flash forward is recomputed in the
    backward under both."""
    x = _embed(params, torch.as_tensor(input_ids))
    layers = params["layers"]
    names = list(layers)
    parts = {n: layers[n].unbind(0) for n in names}

    def block(lp, h):
        return _block(cfg, lp, h)

    for l in range(cfg.num_hidden_layers):
        lp = {n: parts[n][l] for n in names}
        if not cfg.use_remat:
            x = block(lp, x)
        elif cfg.remat_policy == "dots":
            x = checkpoint(block, lp, x, use_reentrant=False,
                           context_fn=_dots_context)
        else:
            x = checkpoint(block, lp, x, use_reentrant=False)
    x = _ln(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_epsilon)
    return (x @ params["wte"].T).float()


def loss_fn(cfg: GPTConfig, params, batch):
    """Mean next-token cross-entropy over every token, in the
    reference's logsumexp form."""
    logits = forward_pure(cfg, params, batch["input_ids"])
    labels = torch.as_tensor(batch["labels"]).to(logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - tgt).mean()


# -- KV-cache inference ------------------------------------------------------

def forward_with_cache(cfg: GPTConfig, params, tokens, cache, pos: int):
    """``tokens`` [B, T] from position ``pos`` against the dense caches
    (updated in place): (logits [B, T, V] f32, cache)."""
    B, T = tokens.shape
    H, eps = cfg.hidden_size, cfg.layer_norm_epsilon
    h = _embed(params, tokens, pos)
    layers = params["layers"]
    for l in range(cfg.num_hidden_layers):
        lp = {k: v[l] for k, v in layers.items()}
        q, k, v = _qkv(cfg, lp, _ln(h, lp["ln1_g"], lp["ln1_b"], eps))
        out, _, _ = decoding.cached_attention_core(q, k, v, cache.k[l],
                                                   cache.v[l], pos)
        h = h + out.reshape(B, T, H) @ lp["proj_w"] + lp["proj_b"]
        h = h + _mlp(lp, _ln(h, lp["ln2_g"], lp["ln2_b"], eps))
    h = _ln(h, params["lnf_g"], params["lnf_b"], eps)
    return (h @ params["wte"].T).float(), cache


def generate(cfg: GPTConfig, params, input_ids, max_new_tokens,
             temperature=0.0, top_k=0, rng=None, eos_token_id=None):
    """[B, P] prompt -> [B, max_new_tokens] continuations (int64) on the
    params' device (``models.decoding``)."""
    return decoding.model_generate(
        lambda p, t, c, pos: forward_with_cache(cfg, p, t, c, pos),
        num_layers=cfg.num_hidden_layers,
        kv_heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
        max_positions=cfg.max_position_embeddings, cache_dtype=cfg.dtype,
        device=params["wte"].device, params=params, input_ids=input_ids,
        max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, rng=rng, eos_token_id=eos_token_id)


# -- the eager class ---------------------------------------------------------

class GPTForCausalLM(decoding.GenerationMixin, _StackedLayer):
    """The eager ``Layer``: parameters ``init_params(config, 0)`` on the
    current place under the reference facade's names; ``forward(ids,
    labels=None)`` is ``forward_pure`` inside one op, with labels
    ``(loss, logits)``."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self._register_tree(init_params(config, 0, device=current_device()))

    def forward(self, input_ids, labels=None):
        cfg = self.config
        return self._forward(lambda tree, ids: forward_pure(cfg, tree, ids),
                             input_ids, labels, "gpt_forward")


GPTForCausalLM._generate_fn = staticmethod(generate)
