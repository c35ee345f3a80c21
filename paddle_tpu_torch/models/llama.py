"""Llama functional core: the port of ``paddle_tpu/models/llama.py``'s
serving half and its single-device train half.

Parameters are a plain dict of tensors in the reference's stacked
layout: every per-layer leaf carries a leading layer axis ``L``, and an
int8 weight is a ``{"q": int8 [L, K, N], "scale": f32 [L, 1, N]}`` leaf
(``quantize_params``).

- ``forward_paged`` is the serving step: one ragged batch of prefill
  chunks and decode tokens over paged K/V pools, with attention in the
  ragged-paged-attention kernel and every matmul of a quantized model in
  the int8 matmul kernel.
- ``forward_pure`` / ``loss_fn`` are the train step's forward: embed ->
  ``run_layer_stack`` (``decoder_layer`` per layer, under the remat
  policy) -> final norm -> ``lm_head``.  ``decoder_layer`` takes the
  fused decoder blocks (``ops.fused_blocks``) where the
  ``fused_blocks`` policy engages them, else the unfused dense
  composition with attention in the flash kernels
  (``ops.flash_attention.causal_attention``).
- Under a topology with ``mp`` > 1 the same forward runs tensor
  parallel over the rank's ``mp`` shards (``shard_params``), with
  sequence-parallel activations under ``sp_axis="mp"``
  (``distributed.tensor_parallel``).  Under ``sp`` > 1 it runs context
  parallel: this rank's block of the sequence, attention by ring
  attention over the ``sp`` ranks (``distributed.sequence_parallel``).
  ``build_train_step`` is the reference's hybrid train step: dp x
  sharding x sp x mp with ZeRO-1 and the overlapped data-parallel
  gradient reduction, or the pipeline over ``pp``
  (``distributed.pipeline``: GPipe, with context parallelism inside it,
  1F1B lockstep or overlapped, interleaved).
- ``forward_with_cache`` / ``generate`` are KV-cache generation over a
  dense cache (``models.decoding``): dense, GQA and MoE, over bf16 or
  int8 weights (every int8 leaf through the int8 matmul kernel), with
  attention in the plain ``cached_attention_core``, as the reference's.
  ``LlamaForCausalLM`` is the eager ``Layer`` over the stacked tree:
  its forward is ``forward_pure`` inside one op.
- ``moe_num_experts`` > 0 replaces each layer's MLP by the reference's
  GShard top-k MoE (``_moe_mlp``) with its load-balancing aux loss,
  which ``run_layer_stack`` sums over the layers and ``loss_fn`` adds at
  0.01.  Its experts split over ``dp`` (``param_specs``) and its tokens
  reach them through ``distributed.expert_parallel``, which makes the
  capacity, the slots and the aux those of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from . import convert, decoding
from .. import flags as _flags
from ..distributed import collective as dcoll
from ..distributed import expert_parallel as dexp
from ..distributed import mesh as dmesh
from ..distributed import overlap as doverlap
from ..distributed import pipeline as dpipe
from ..distributed import sequence_parallel as dseq
from ..distributed import tensor_parallel as tpar
from ..distributed.zero import ZeroOptimizer
from ..ops import fused_blocks as fb
from ..ops.flash_attention import causal_attention
from ..ops.int8_matmul import int8_matmul, quantize_int8
from ..ops.ragged_paged_attention import ragged_paged_attention
from ..core.place import current_device
from ..core.tensor import Tensor, apply_op, to_tensor
from ..nn.layer.layers import Layer, Parameter

__all__ = ["LlamaConfig", "PRESETS", "preset", "init_params",
           "quantize_params", "forward_paged", "decoder_layer",
           "run_layer_stack", "forward_pure", "loss_fn", "param_specs",
           "shard_params", "gather_params", "adamw", "build_train_step",
           "forward_with_cache", "generate", "LlamaForCausalLM"]

@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # MoE (the DeepSeekMoE / Qwen-MoE shape): 0 = the dense MLP
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # int8 weight path: None follows FLAGS_tpu_quantized; "auto" = on
    # CUDA only, "on" = everywhere (the CPU runs the plain int8 version,
    # what parity tests use), "off" = dense weights
    quantized: Optional[str] = None
    # training: remat per layer; "full" recomputes the whole layer in the
    # backward, "dots" saves the matmul outputs and recomputes the rest
    use_remat: bool = True
    remat_policy: str = "dots"
    # fused decoder blocks: None follows FLAGS_tpu_fused_blocks; "auto"
    # = on CUDA tensors only, "on" = on any device (the CPU runs the
    # plain versions, what parity tests use), "off" = the unfused
    # composition; see _fused_block_modes
    fused_blocks: Optional[str] = None

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.fused_blocks not in (None, "auto", "on", "off"):
            raise ValueError(f"fused_blocks must be None, 'auto', 'on' or "
                             f"'off', got {self.fused_blocks!r}")
        if self.quantized not in (None, "auto", "on", "off"):
            raise ValueError(f"quantized must be None, 'auto', 'on' or "
                             f"'off', got {self.quantized!r}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


# The LlamaConfig defaults ARE the 7B shape, so llama7b overrides nothing.
PRESETS: Dict[str, Dict[str, Any]] = {
    "llama7b": {},
    "llama1b": dict(hidden_size=2048, intermediate_size=5504,
                    num_hidden_layers=16, num_attention_heads=16,
                    num_key_value_heads=16),
    "llama-debug": dict(vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4,
                        max_position_embeddings=256),
}


def preset(name: str, **overrides) -> LlamaConfig:
    """LlamaConfig from a named preset, with field overrides on top."""
    if name not in PRESETS:
        raise KeyError(f"unknown llama preset {name!r}; "
                       f"available: {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return LlamaConfig(**kw)


def init_params(cfg: LlamaConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Stacked parameter dict (layer axis L leads every per-layer
    tensor), drawn N(0, 0.02) from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless the caller names another).
    Layer leaves are drawn one layer at a time, so the float32 draw never
    holds more than one layer's weight.  Under MoE the layers hold a
    float32 ``router`` [L, H, E] and ``w_gate``/``w_up`` [L, E, H, I],
    ``w_down`` [L, E, I, H] (reference llama.py:151-157)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    V = cfg.vocab_size
    KV = cfg.num_key_value_heads * cfg.head_dim
    std = 0.02

    def init(shape):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (out if len(shape) >= 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * std)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    embed = init((V, H))
    layers = {
        "ln1": ones((L, H)),
        "wq": init((L, H, H)),
        "wk": init((L, H, KV)),
        "wv": init((L, H, KV)),
        "wo": init((L, H, H)),
        "ln2": ones((L, H)),
    }
    E = cfg.moe_num_experts
    if E > 0:
        # the reference rounds the draw to the model dtype, then to f32
        layers["router"] = init((L, H, E)).float()
        layers.update(w_gate=init((L, E, H, I)), w_up=init((L, E, H, I)),
                      w_down=init((L, E, I, H)))
    else:
        layers.update(w_gate=init((L, H, I)), w_up=init((L, H, I)),
                      w_down=init((L, I, H)))
    return {"embed": embed, "layers": layers, "norm_f": ones((H,)),
            "lm_head": init((H, V))}


# ---------------------------------------------------------------------------
# pure forward pieces
# ---------------------------------------------------------------------------

def _rope_tables(cfg: LlamaConfig, seq_len: int, device):
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                       # [S, half]
    emb = torch.cat([freqs, freqs], dim=-1)                # [S, D]
    return torch.sin(emb), torch.cos(emb)


def _rms_norm(x, w, eps):
    # normalise in fp32, cast to the activation dtype, THEN scale: the
    # reference's order, which bf16 parity depends on
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _qmm(x, w):
    """x @ w, where ``w`` is a dense tensor or a ``quantize_params`` leaf
    ``{"q": int8 [K, N], "scale": f32 [1, N]}`` that goes through the
    int8 matmul."""
    if isinstance(w, dict):
        return int8_matmul(x, w["q"], w["scale"])
    return x @ w


def _dense_mlp(lp, x):
    gate = F.silu(_qmm(x, lp["w_gate"]))
    up = _qmm(x, lp["w_up"])
    return _qmm(gate * up, lp["w_down"])


def _moe_route(cfg: LlamaConfig, router, xt, B: int, ep=None):
    """The routing of ``_moe_mlp`` for the tokens ``xt`` [T, H] of ``B``
    rows: ``(probs [T, E] f32, gate_vals [T, K] f32, gate_idx [T, K],
    keep [T, K], slot [T * K], C)``; ``slot`` is ``expert * C + pos``,
    or ``E * C`` (the trash row) for a dropped assignment."""
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    T = xt.shape[0]
    T_all = T * (1 if ep is None else ep.n_tokens)
    C = max(1, int(cfg.moe_capacity_factor * T_all * K / E))
    probs = torch.softmax(xt.float() @ router, dim=-1)          # [T, E]
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # [T, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # each (t, k)'s slot: the assignments to its expert before it, in
    # the global (t, k) order (a local row's are counted from the
    # assignments of every row block before it)
    onehot = F.one_hot(gate_idx, E).view(B, T // B * K, E)
    before = onehot.cumsum(1) - onehot + dexp.slot_offsets(
        onehot.sum(1), ep)[:, None, :]
    pos = (before * onehot).sum(-1).view(T, K)
    keep = pos < C
    slot = torch.where(keep, gate_idx * C + pos, E * C).view(-1)
    return probs, gate_vals, gate_idx, keep, slot, C


def _moe_mlp(cfg: LlamaConfig, lp, x, tp=None, ep=None):
    """GShard top-k MoE with capacity (reference llama.py:362-402):
    (out [B, S, H], aux).

    The router's logits are f32; softmax, top-k, the gates renormalised
    over k.  Each ``(token, k)`` takes the next slot of its expert's
    buffer in ``(t, k)`` order and is kept while the slot is below
    ``C = max(1, int(cf * T * K / E))`` (``_moe_route``).  Dispatch and
    combine go by index (scatter into ``[E, C, H]`` by (expert, slot),
    gather back), not through the reference's one-hot ``[T, K, E, C]``
    tensor: each slot holds at most one token, so it is the same sum.  A
    dropped assignment goes to a trash row past the buffer, so nothing
    here depends on the data's shape (no host sync).  The combine
    weights are cast to ``x``'s dtype before the combine, as the
    reference's ``combine`` tensor is.  ``aux = E * sum(me * ce)``, with
    ``me`` the mean router probability and ``ce`` the share of tokens
    whose first choice is each expert.

    ``ep`` (``distributed.expert_parallel``): the tokens of the global
    batch share the buffers, this rank's experts are its ``E/dp`` block,
    and ``T`` counts the global tokens.  ``tp``: every row is routed (the
    rows are gathered under sequence parallelism), the experts' products
    are column then row parallel over ``mp`` between ``enter`` and
    ``leave``, and the aux's gradient is split over the ``mp`` ranks,
    each of which computes it whole."""
    if tp is not None:
        x = tpar.enter(x, tp)
    B, S, H = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    if lp["w_gate"].shape[0] * (1 if ep is None else ep.ep_size) != E:
        raise ValueError(f"w_gate {tuple(lp['w_gate'].shape)} is not a "
                         f"block of {E} experts over dp (shard_params)")
    xt = x.reshape(T, H)
    probs, gate_vals, gate_idx, keep, slot, C = _moe_route(
        cfg, lp["router"], xt, B, ep)
    _note_routing(keep)
    buf = xt.new_zeros((E * C + 1, H)).index_add(
        0, slot, xt.repeat_interleave(K, dim=0))
    expert_in = buf[:E * C].view(E, C, H)
    if ep is not None:
        expert_in = dexp.dispatch(expert_in, ep)                # [E/dp,C,H]
    gate = F.silu(torch.bmm(expert_in, lp["w_gate"]))
    up = torch.bmm(expert_in, lp["w_up"])
    expert_out = torch.bmm(gate * up, lp["w_down"])
    if ep is not None:
        expert_out = dexp.combine(expert_out, ep)               # [E, C, H]
    rows = torch.cat([expert_out.reshape(E * C, H),
                      expert_out.new_zeros((1, H))])[slot]
    w = gate_vals.to(x.dtype).float().view(T * K, 1)
    out = (rows.float() * w).view(T, K, H).sum(1).to(x.dtype)
    # the aux loss from the global means: one sum over the token ranks
    T_all = T * (1 if ep is None else ep.n_tokens)
    sums = torch.cat([probs.sum(0),
                      F.one_hot(gate_idx[:, 0], E).float().sum(0)])
    mp = 1 if tp is None else tp.size
    sums = dexp.token_sum(sums, ep, 1.0 / (
        mp * (1 if ep is None else ep.n_seq))) / T_all
    aux = E * torch.sum(sums[:E] * sums[E:])
    out = out.view(B, S, H)
    if tp is not None:
        out = tpar.leave(out, tp)
    return out, aux


# the routing counters of ``moe_routing``: None when nobody counts
_ROUTING: list = [None]


def _note_routing(keep):
    if _ROUTING[0] is not None:
        _ROUTING[0].append((keep.numel(), (~keep).sum()))


class moe_routing:
    """``with llama.moe_routing() as r:`` counts every MoE layer call's
    ``(token, k)`` assignments and the dropped ones; ``r.dropped_share()``
    is their ratio (one host sync, at the end).  A layer recomputed under
    remat counts twice, with the same routing, so the ratio holds."""

    def __enter__(self):
        self.calls = []
        _ROUTING[0] = self.calls
        return self

    def __exit__(self, *exc):
        _ROUTING[0] = None
        return False

    def dropped_share(self) -> float:
        n = sum(c for c, _ in self.calls)
        d = sum(int(x) for _, x in self.calls)
        return d / n if n else 0.0


def _quantized_mode(cfg: LlamaConfig, device) -> bool:
    """Resolved int8-weight policy: ``cfg.quantized``, else
    ``FLAGS_tpu_quantized`` (default "auto", reference llama.py:284-302).
    "auto" quantizes on CUDA only; "on" everywhere; "off" never."""
    mode = cfg.quantized or _flags.flag("FLAGS_tpu_quantized")
    if mode == "off":
        return False
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return True


# weight leaves quantize_params converts (per-layer stacked [L, K, N]);
# norms, embed and the MoE layers' weights stay dense
_QUANT_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_stacked(w):
    """quantize_int8 one layer at a time (same result as the whole
    stack: the absmax runs over K within each layer)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]),
                        dtype=torch.float32, device=w.device)
    for l in range(w.shape[0]):
        q[l], scale[l] = quantize_int8(w[l])
    return {"q": q, "scale": scale}


def _note_quant_err(name, w, q, scale):
    """The numerics watchdog's quantization-error notes (the reference's
    ``_note_quant_err``): rms and absmax of dequant - weight, and for a
    stacked [L, K, N] weight the worst layer, so a bad scale is
    localized like a NaN.  Behind FLAGS_tpu_check_nan_inf."""
    from ..profiler import numerics
    if not numerics.enabled():
        return
    # on the host in numpy f32, the reference's arithmetic
    wf = w.detach().float().cpu().numpy()
    err = (q.cpu().numpy().astype(np.float32)
           * scale.float().cpu().numpy()) - wf
    if err.size == 0:
        return
    numerics.note(f"quant_err_rms_{name}",
                  float(np.sqrt(np.mean(err * err))))
    numerics.note(f"quant_err_absmax_{name}", float(np.max(np.abs(err))))
    if err.ndim == 3:
        numerics.note(f"quant_err_worst_layer_{name}",
                      float(np.argmax(np.max(np.abs(err), axis=(1, 2)))))


def quantize_params(cfg: LlamaConfig, params):
    """PTQ the serving weight path to int8: each matmul weight in
    ``_QUANT_WEIGHTS`` plus ``lm_head`` becomes a ``{"q", "scale"}``
    leaf (per-output-channel absmax, ``quantize_int8``), its error noted
    for the numerics watchdog (``_note_quant_err``).  Under MoE only
    ``lm_head`` is quantized: the reference leaves every layer weight
    dense there (llama.py:345).  Idempotent: already-quantized leaves
    pass through."""
    out = dict(params)
    layers = dict(params["layers"])
    for nm in _QUANT_WEIGHTS if cfg.moe_num_experts == 0 else ():
        w = layers.get(nm)
        if w is not None and not isinstance(w, dict):
            layers[nm] = _quantize_stacked(w)
            _note_quant_err(nm, w, layers[nm]["q"], layers[nm]["scale"])
    out["layers"] = layers
    head = out.get("lm_head")
    if head is not None and not isinstance(head, dict):
        q, scale = quantize_int8(head)
        out["lm_head"] = {"q": q, "scale": scale}
        _note_quant_err("lm_head", head, q, scale)
    return out


def _layer(leaf, l):
    if isinstance(leaf, dict):
        return {k: v[l] for k, v in leaf.items()}
    return leaf[l]


def forward_paged(cfg: LlamaConfig, params, tokens, k_pages, v_pages,
                  block_tables, seq_lens, q_lens, *,
                  k_scales=None, v_scales=None):
    """Ragged mixed prefill + decode forward over a paged KV cache (the
    serving engine's step function).

    tokens        [R, Tc] int     current-chunk token slots; request r
                                  uses tokens[r, :q_lens[r]]
    k/v_pages     [L, nkv, P, page, d] per-layer pools, UPDATED IN PLACE
    block_tables  [R, Bmax] int32 pool page of each logical kv block
                                  (page 0 = reserved null page, absorbs
                                  padding-token writes)
    seq_lens      [R] int32       total kv length incl. this chunk
    q_lens        [R] int32       chunk lengths (0 = inactive slot)
    k/v_scales    [L, nkv, P] f32 per-page dequant scales, UPDATED IN
                                  PLACE; their presence selects int8
                                  pools (quantize on write, dequantize
                                  on read inside the attention kernel)

    Rope runs at each token's absolute position (seq_lens - q_lens + t),
    the new k/v are written into the pools through the block table, and
    attention is ``ragged_paged_attention``.  Returns (logits [R, Tc, V]
    fp32, (k_pages, v_pages)), with scales (k_pages, v_pages, k_scales,
    v_scales); these are the same tensors the caller passed.  Logits in
    padding rows are garbage by contract: callers read row q_lens[r] - 1.

    int8 write path (the reference's, llama.py:670-716): for each request
    a window of W = Tc // page + 2 logical blocks from the chunk's first
    page is gathered and dequantized, the chunk's new k/v are inserted,
    every window position at or past seq_len is zeroed (a recycled page
    keeps its previous owner's bytes, which must not reach the new page
    absmax), each page is rescaled to max(absmax, 1e-8) / 127, rounded
    half to even and clamped to +-127, and written back.  Only valid
    window slots are written: never page 0, never past Bmax, nothing for
    a q_len == 0 slot.  The window starts at the chunk's first page,
    which is private to the request even when the prefix cache shares
    the pages before it, and every window is gathered before any is
    written, so the in-place update reads no page another window wrote.

    The reference returns new pools (JAX arrays are immutable); here the
    step writes into the pools in place, which halves the pool memory a
    step needs.

    Under MoE every layer's MLP is ``_moe_mlp`` over all ``R * Tc``
    token slots, padding slots and empty rows included, as in the
    reference (llama.py:754-755): they take capacity in row order, so
    they are routed with the same hidden states (a padding slot's
    attention output is an exact zero in both packages)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    R, Tc = tokens.shape
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    H = cfg.hidden_size
    rep = nh // nkv
    L, _, num_pages, page, _ = k_pages.shape
    dev = k_pages.device
    Bmax = block_tables.shape[1]

    # absolute position of each token slot, clipped for the rope gather
    lens = seq_lens.long()
    start = lens - q_lens.long()                             # [R]
    t_off = torch.arange(Tc, dtype=torch.long, device=dev)
    qpos = start[:, None] + t_off[None, :]                   # [R, Tc]
    valid = t_off[None, :] < q_lens.long()[:, None]          # [R, Tc]
    qpos_c = qpos.clamp(0, cfg.max_position_embeddings - 1)
    sin_full, cos_full = _rope_tables(cfg, cfg.max_position_embeddings, dev)
    sin = sin_full[qpos_c]                                   # [R, Tc, D]
    cos = cos_full[qpos_c]

    def rope(x):
        # per-token tables (ragged positions), neox style
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return (x * cos[:, :, None, :].to(x.dtype)
                + rot * sin[:, :, None, :].to(x.dtype))

    quant_kv = k_scales is not None
    if quant_kv:
        quant_write = _quant_window_writer(start, qpos, valid, lens,
                                           q_lens, block_tables, page, Tc)
    else:
        # flat pool slot of each new token, through the block table;
        # padding tokens land on the null page, which the kernel never
        # reads (it reads only pages with j * page < kvlen)
        blk = (qpos_c // page).clamp(0, Bmax - 1)
        phys = block_tables.long().gather(1, blk)            # [R, Tc]
        dest = torch.where(valid, phys * page + qpos_c % page,
                           torch.zeros_like(phys)).reshape(-1)

    h = params["embed"][tokens.long()]                       # [R, Tc, H]
    layers = params["layers"]
    for l in range(L):
        lp = {k: _layer(v, l) for k, v in layers.items()}
        xn = _rms_norm(h, lp["ln1"], cfg.rms_norm_eps)
        q = rope(_qmm(xn, lp["wq"]).reshape(R, Tc, nh, d))
        k = rope(_qmm(xn, lp["wk"]).reshape(R, Tc, nkv, d))
        v = _qmm(xn, lp["wv"]).reshape(R, Tc, nkv, d)
        kp, vp = k_pages[l], v_pages[l]                      # [nkv, P, page, d]
        ks = vs = None
        if quant_kv:
            ks, vs = k_scales[l], v_scales[l]                # [nkv, P]
            quant_write(kp, vp, ks, vs, k, v)
        else:
            # write the new k/v into the pools in place: [R, Tc, nkv, d]
            # -> [nkv, R*Tc, d] at the flat slots of the [nkv, P*page, d]
            # view
            kp.view(nkv, num_pages * page, d).index_copy_(
                1, dest, k.permute(2, 0, 1, 3).reshape(nkv, R * Tc, d)
                .to(kp.dtype))
            vp.view(nkv, num_pages * page, d).index_copy_(
                1, dest, v.permute(2, 0, 1, 3).reshape(nkv, R * Tc, d)
                .to(vp.dtype))
        # kernel layout [R, nkv, Tc*rep, d]: row t*rep + j = q head
        # k*rep + j of token t (the h // rep GQA mapping)
        qk = q.reshape(R, Tc, nkv, rep, d).permute(0, 2, 1, 3, 4).reshape(
            R, nkv, Tc * rep, d)
        out = ragged_paged_attention(qk, kp, vp, block_tables, seq_lens,
                                     q_lens, rep=rep, k_scales=ks,
                                     v_scales=vs)
        out = out.reshape(R, nkv, Tc, rep, d).permute(0, 2, 1, 3, 4).reshape(
            R, Tc, H)
        h = h + _qmm(out.to(h.dtype), lp["wo"])
        hn = _rms_norm(h, lp["ln2"], cfg.rms_norm_eps)
        if cfg.moe_num_experts > 0:
            h = h + _moe_mlp(cfg, lp, hn)[0]
        else:
            h = h + _dense_mlp(lp, hn)
    x = _rms_norm(h, params["norm_f"], cfg.rms_norm_eps)
    logits = _qmm(x, params["lm_head"]).float()
    if quant_kv:
        return logits, (k_pages, v_pages, k_scales, v_scales)
    return logits, (k_pages, v_pages)


def _quant_window_writer(start, qpos, valid, lens, q_lens, block_tables,
                         page, Tc):
    """The int8 write of one step (``forward_paged``'s docstring).  The
    window geometry is the same for every layer, so it is built once; the
    returned ``write(kp, vp, ks, vs, k, v)`` updates one layer's
    [nkv, P, page, d] int8 pools and [nkv, P] scales in place with the
    chunk's new k, v [R, Tc, nkv, d].  K and V go through each op
    together, and only the window slots that are written are gathered
    (every other slot's result would be dropped): the same bytes as the
    reference's whole-window computation, in half the launches."""
    dev = block_tables.device
    R, Bmax = block_tables.shape
    W = Tc // page + 2
    first_blk = start.clamp_min(0) // page                   # [R]
    wblk = first_blk[:, None] + torch.arange(W, device=dev)[None, :]
    phys_w = block_tables.long().gather(1, wblk.clamp(0, Bmax - 1))
    wvalid = (wblk < Bmax) & (q_lens.long() > 0)[:, None] & (phys_w > 0)
    keep = wvalid.reshape(-1).nonzero().squeeze(1)           # slots written
    dst = phys_w.reshape(-1)[keep]                           # their pages
    slot_of = torch.full((R * W,), -1, dtype=torch.long, device=dev)
    slot_of[keep] = torch.arange(keep.numel(), device=dev)
    # the chunk's tokens: (request, chunk position) -> (kept slot, row)
    tok_r, tok_t = valid.nonzero(as_tuple=True)
    rel = (qpos - (first_blk * page)[:, None])[tok_r, tok_t]
    tok_slot = slot_of[tok_r * W + rel // page]
    tok_row = rel % page
    wpos = (first_blk * page)[:, None] + torch.arange(
        W * page, device=dev)[None, :]
    live = (wpos < lens[:, None]).reshape(R * W, page)[keep]
    live = live[None, None, :, :, None]                      # [1,1,K,page,1]

    def write(kp, vp, ks, vs, k, v):
        win = torch.stack((kp.index_select(1, dst), vp.index_select(1, dst)))
        sc = torch.stack((ks.index_select(1, dst), vs.index_select(1, dst)))
        deq = win.float() * sc[..., None, None]     # [2, nkv, K, page, d]
        new = torch.stack((k, v))[:, tok_r, tok_t]  # [2, n, nkv, d]
        deq[:, :, tok_slot, tok_row] = new.transpose(1, 2).float()
        deq = torch.where(live, deq, 0.0)
        new_sc = deq.abs().amax(dim=(3, 4)).clamp_min(1e-8) / 127.0
        qp = torch.round(deq / new_sc[..., None, None]).clamp_(-127, 127)
        qp = qp.to(kp.dtype)
        kp.index_copy_(1, dst, qp[0])
        vp.index_copy_(1, dst, qp[1])
        ks.index_copy_(1, dst, new_sc[0])
        vs.index_copy_(1, dst, new_sc[1])

    return write


# ---------------------------------------------------------------------------
# the train half: forward_pure -> loss_fn, tensor parallel over mp
# ---------------------------------------------------------------------------

def _apply_rope(x, sin, cos):
    """Neox rope on x [B, S, H, D] with tables [S, D], cast to x's dtype
    before the multiply as the reference does."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[None, :, None, :].to(x.dtype)
            + rot * sin[None, :, None, :].to(x.dtype))


def _attention(cfg: LlamaConfig, lp, x, sin, cos, mp: int = 1, cp=None):
    """Self-attention of one layer: qkv projections, rope, GQA kv-head
    repeat (``jnp.repeat`` = ``repeat_interleave``), causal flash
    attention, output projection.  With ``mp`` > 1 the weights are this
    rank's blocks (its H/mp heads and KV/mp kv heads) and the result is
    its partial sum of the output projection.  Under context
    parallelism (``cp``, the ``sp`` group) ``x`` is this rank's block of
    the sequence and attention is ring attention over the group, which
    expands the kv heads at use (the reference's context-parallel
    branch, llama.py:239-251)."""
    B, S, _ = x.shape
    nh, nkv, d = (cfg.num_attention_heads // mp,
                  cfg.num_key_value_heads // mp, cfg.head_dim)
    q = _apply_rope(_qmm(x, lp["wq"]).reshape(B, S, nh, d), sin, cos)
    k = _apply_rope(_qmm(x, lp["wk"]).reshape(B, S, nkv, d), sin, cos)
    v = _qmm(x, lp["wv"]).reshape(B, S, nkv, d)
    if cp is not None:
        out = dseq.ring_attention(q, k, v, cp)
        return _qmm(out.reshape(B, S, nh * d), lp["wo"])
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = causal_attention(q, k, v)
    return _qmm(out.reshape(B, S, nh * d), lp["wo"])


def _fused_block_modes(cfg: LlamaConfig, x, tp=None, cp=None):
    """(use_fused_attention, use_fused_mlp) for the activation ``x``
    (reference llama.py:405-430).  ``fused_blocks`` None follows
    ``FLAGS_tpu_fused_blocks`` (default "auto"): "auto" engages on CUDA
    tensors only, "on" on any device, "off" never.  The fused attention
    block also needs as many kv heads as heads, a head dim the flash
    kernels take
    and no context parallelism (``cp``: attention is the ring); the
    fused MLP needs no MoE and runs on the rank's rows of the sequence
    under ``cp``; both need the kernels' shapes
    (``fused_blocks.fused_*_ok``) and a whole layer: under tensor
    parallelism (``tp``) each rank holds a block of the products and the
    kernels' residual add would run on every rank, so the layer takes
    the composition."""
    mode = cfg.fused_blocks or _flags.flag("FLAGS_tpu_fused_blocks")
    if (tp is not None or mode == "off"
            or (mode == "auto" and x.device.type != "cuda")):
        return False, False
    H = cfg.hidden_size
    attn_ok = (cp is None
               and cfg.num_key_value_heads == cfg.num_attention_heads
               and fb.fused_attention_ok(H, cfg.head_dim))
    mlp_ok = (cfg.moe_num_experts == 0
              and fb.fused_mlp_ok(H, cfg.intermediate_size))
    return attn_ok, mlp_ok


def decoder_layer(cfg: LlamaConfig, lp, x, sin, cos, tp=None, cp=None,
                  ep=None):
    """One decoder block on a per-layer param slice (no leading L axis):
    ``(h, aux)``, the fused blocks where ``_fused_block_modes`` engages
    them, else the unfused dense composition, and under MoE the MoE
    layer in place of the MLP (reference llama.py:433-465; ``aux`` is a
    zero without MoE).  Under tensor parallelism (``tp``, a
    ``tensor_parallel.TensorParallel``) the slice holds this rank's
    blocks, the norms and residuals run on the rows ``x`` holds (S/mp of
    them under sequence parallelism), and each block's products sit
    between ``enter`` and ``leave``.  Under context parallelism (``cp``,
    the ``sp`` group) ``x`` is this rank's block of the sequence and
    ``sin``/``cos`` its positions' rows.  ``ep``: the MoE layer's expert
    parallelism (``_moe_mlp``)."""
    fused_attn, fused_mlp = _fused_block_modes(cfg, x, tp, cp)
    if isinstance(lp.get("wq"), dict) or isinstance(lp.get("w_gate"), dict):
        # int8 quantize_params leaves: the fused kernels take dense
        # weights, so quantized layers take the unfused composition
        fused_attn = fused_mlp = False
    if tp is None:
        into = out = (lambda t: t)
    else:
        def into(t):
            return tpar.enter(t, tp)

        def out(t):
            return tpar.leave(t, tp)
    mp = 1 if tp is None else tp.size
    eps = cfg.rms_norm_eps
    if fused_attn:
        h = fb.fused_attention_block(x, lp["ln1"], lp["wq"], lp["wk"],
                                     lp["wv"], lp["wo"], sin, cos,
                                     head_dim=cfg.head_dim, eps=eps)
    else:
        h = x + out(_attention(cfg, lp, into(_rms_norm(x, lp["ln1"], eps)),
                               sin, cos, mp, cp))
    if cfg.moe_num_experts > 0:
        mlp_out, aux = _moe_mlp(cfg, lp, _rms_norm(h, lp["ln2"], eps), tp,
                                ep)
        return h + mlp_out, aux
    no_aux = x.new_zeros((), dtype=torch.float32)
    if fused_mlp:
        return fb.fused_mlp_block(h, lp["ln2"], lp["w_gate"], lp["w_up"],
                                  lp["w_down"], eps=eps), no_aux
    return h + out(_dense_mlp(lp, into(_rms_norm(h, lp["ln2"], eps)))), \
        no_aux


# matmul ops whose outputs the "dots" policy keeps (jax's dots_saveable)
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default]


def _dots_context():
    return create_selective_checkpoint_contexts(_DOT_OPS)


def run_layer_stack(cfg: LlamaConfig, stacked, x, sin, cos, tp=None,
                    grad_sync=None, cp=None, ep=None):
    """The layers in a Python loop (the reference's ``lax.scan``); returns
    the hidden state and the layers' aux losses summed (f32; zero
    without MoE).

    Remat per layer, as the reference's ``jax.checkpoint`` around the
    scan body: ``use_remat=False`` saves every activation; ``"full"``
    is ``torch.utils.checkpoint`` (non-reentrant) around the layer,
    which saves only its inputs; ``"dots"`` is the same with a
    selective policy that saves the outputs of ``aten.mm`` / ``addmm`` /
    ``bmm`` and recomputes everything else.  Under both policies the
    flash forward, and on the fused path the forward kernels of both
    fused blocks, are recomputed in the backward (a kernel is not a
    matmul op, and ``dots_saveable`` does not save a custom VJP's
    outputs either), so a step launches each twice per layer.  The
    kernels are launched through ctypes outside the dispatcher; their
    outputs are made by ``torch.empty`` of the same shapes on recompute,
    so checkpoint's saved-tensor metadata check holds.  Under tensor
    parallelism the recompute runs the layer's forward collectives
    again too (``enter``/``leave`` are not matmul ops): every rank runs
    the same backward graph, so they run in the same order on every
    rank.

    The stacked leaves are split with one ``unbind`` each, whose
    backward writes every layer's gradient into one stacked tensor (a
    per-layer index would add a full-size zero tensor per layer).
    ``grad_sync`` (a ``distributed.overlap.Reducer``): each layer's
    slices go through ``reduce_in_backward``, and every ``unbind``'s
    backward first waits for the reductions started so far (the
    reference's ``grad_sync_axis``).  ``cp``: context parallelism (see
    ``decoder_layer``); the recompute runs the ring's shifts again, the
    same on every rank of the ring.  ``ep``: the MoE layers' expert
    parallelism; the recompute reroutes from the saved router logits
    (the same routing) and runs the layer's expert-parallel collectives
    again, in the same order on every rank, as the tensor-parallel ones.
    The aux comes out of the checkpointed layer with its hidden state.
    A pipeline stage or virtual chunk runs its contiguous block of
    layers through it unchanged."""
    names = list(stacked)
    L = stacked[names[0]].shape[0]
    parts = {n: stacked[n].unbind(0) for n in names}
    if grad_sync is not None:
        for n in names:
            if parts[n][0].grad_fn is not None:
                parts[n][0].grad_fn.register_prehook(grad_sync.wait_all)
    per_layer = [{n: parts[n][l] for n in names} for l in range(L)]

    def layer(lp, h):
        return decoder_layer(cfg, lp, h, sin, cos, tp, cp, ep)

    moe = cfg.moe_num_experts > 0
    aux = None
    for l in range(L):
        lp = per_layer[l]
        if grad_sync is not None:
            lp = doverlap.reduce_tree_in_backward(lp, grad_sync)
        if not cfg.use_remat:
            x, a = layer(lp, x)
        elif cfg.remat_policy == "full":
            x, a = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x, a = checkpoint(layer, lp, x, use_reentrant=False,
                              context_fn=_dots_context)
        if moe:
            aux = a if aux is None else aux + a
    return x, (aux if moe else x.new_zeros((), dtype=torch.float32))


def _check_tensor_parallel(cfg: LlamaConfig, mp: int, dp: int = 1):
    """The shapes tensor parallelism over ``mp`` ranks splits evenly, and
    the experts over ``dp``."""
    for what, n in (("num_attention_heads", cfg.num_attention_heads),
                    ("num_key_value_heads", cfg.num_key_value_heads),
                    ("vocab_size", cfg.vocab_size),
                    ("intermediate_size", cfg.intermediate_size)):
        if n % mp:
            raise ValueError(f"{what}={n} does not split over mp={mp}")
    if cfg.moe_num_experts % dp:
        raise ValueError(f"moe_num_experts={cfg.moe_num_experts} does not "
                         f"split over dp={dp}")


def _tensor_parallel(topo, sp_axis):
    """The tensor-parallel context of a forward: None unless the topology
    (``topo``, else the one ``init_mesh`` built) has mp > 1."""
    if sp_axis not in (None, "mp"):
        raise ValueError(
            f"sp_axis must be None or 'mp' (sequence-parallel activations "
            f"over mp), got {sp_axis!r}; context parallelism over 'sp' "
            f"comes from the topology's sp degree")
    if topo is None:
        topo = dmesh.get_topology(create=False)
    if topo is None or topo.mp_degree == 1:
        return None
    return tpar.TensorParallel(topo.group("mp"), topo.mp_degree,
                               topo.coords["mp"], sp_axis == "mp")


def _expert_parallel(cfg: LlamaConfig, topo, seq: bool):
    """The MoE layers' expert-parallel context (``topo``, else the one
    ``init_mesh`` built): None without MoE or when no other rank's tokens
    share the experts.  ``seq``: context parallelism outside the
    pipeline, whose sequence blocks share the buffers."""
    if cfg.moe_num_experts == 0:
        return None
    if topo is None:
        topo = dmesh.get_topology(create=False)
    ep = dexp.expert_parallel(topo, seq)
    if ep is not None:
        _check_tensor_parallel(cfg, 1, ep.ep_size)
    return ep


def _context_parallel(topo):
    """The ``sp`` group of a topology with sp > 1 (``topo``, else the one
    ``init_mesh`` built), else None."""
    if topo is None:
        topo = dmesh.get_topology(create=False)
    if topo is None or topo.sp_degree == 1:
        return None
    return topo.group("sp")


def _embed(cfg: LlamaConfig, params, ids, tp):
    """The embedding lookup (vocab-parallel under ``tp``)."""
    if isinstance(params["lm_head"], dict):
        raise NotImplementedError("training takes dense weights, not "
                                  "quantize_params leaves")
    embed = params["embed"]
    if tp is None:
        return F.embedding(ids, embed)
    _check_tensor_parallel(cfg, tp.size)
    if embed.shape[0] * tp.size != cfg.vocab_size:
        raise ValueError(f"embed {tuple(embed.shape)} is not a block "
                         f"of mp={tp.size} (shard_params)")
    if tp.sp and ids.shape[1] % tp.size:
        raise ValueError(f"sequence {ids.shape[1]} does not split over "
                         f"mp={tp.size}")
    return tpar.embedding(ids, embed, tp)


def _logits(cfg: LlamaConfig, params, x, tp):
    """Final norm and ``lm_head``: f32 logits (this rank's vocab block
    under ``tp``)."""
    x = _rms_norm(x, params["norm_f"], cfg.rms_norm_eps)
    if tp is not None:
        x = tpar.enter(x, tp)
    return _qmm(x, params["lm_head"]).float()


def _ce(logits, labels, tp):
    """Mean next-token cross-entropy over the tokens of ``labels``, in
    the reference's logsumexp form (vocab-parallel under ``tp``)."""
    labels = labels.to(logits.device).long()
    if tp is not None:
        return tpar.cross_entropy(logits, labels, tp).mean()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - tgt).mean()


def _rope_rows(cfg: LlamaConfig, S: int, device, topo, cp):
    """The rope tables of a sequence of ``S``, cut to this rank's block
    of positions under context parallelism; with that block (a range)."""
    sin, cos = _rope_tables(cfg, S, device)
    if cp is None:
        return sin, cos, range(S)
    if topo is None:
        topo = dmesh.get_topology()
    blk = topo.sequence_block(S)
    return sin[blk.start:blk.stop], cos[blk.start:blk.stop], blk


def _forward(cfg: LlamaConfig, params, input_ids, tp, grad_sync, cp=None,
             topo=None):
    embed = params["embed"]
    ids = input_ids.to(embed.device).long()
    sin, cos, blk = _rope_rows(cfg, ids.shape[1], embed.device, topo, cp)
    x = _embed(cfg, params, ids[:, blk.start:blk.stop], tp)
    x, aux = run_layer_stack(cfg, params["layers"], x, sin, cos, tp=tp,
                             grad_sync=grad_sync, cp=cp,
                             ep=_expert_parallel(cfg, topo, cp is not None))
    return _logits(cfg, params, x, tp), aux


def forward_pure(cfg: LlamaConfig, params, input_ids, sp_axis=None,
                 cp_mesh=None, *, topo=None, grad_sync=None):
    """Full forward: ids [B, S] -> (logits [B, S, V] f32, aux), on the
    device the params are on; ``aux`` is the MoE layers' aux loss summed
    (a zero without MoE).

    Under a topology with mp > 1 (``topo``, else the one ``init_mesh``
    built; ``cp_mesh``, the reference's argument, names one too) the
    params are this rank's shards (``shard_params``), the layers run
    tensor parallel, and the result is this rank's [B, S, V/mp] block
    of the logits.  ``sp_axis="mp"`` (what the reference's train step
    passes) keeps S/mp rows of the activations between the blocks; with
    mp = 1 it changes nothing, as in the reference on one device.  With
    sp > 1 the forward is context parallel (the reference's
    ``cp_mesh``): ``input_ids`` are the whole sequence on every rank of
    an ``sp`` slice, each rank runs its block of it
    (``HybridTopology.sequence_block``) with ring attention, and the
    result is that block's logits [B, S/sp, V(/mp)]; ``sp_axis`` is
    ignored there, as in the reference.  Under MoE the experts split
    over ``dp`` and the layers route the global batch's tokens
    (``_moe_mlp``; under context parallelism every rank's sequence block
    too), so ``aux`` is the global batch's on every rank.
    ``grad_sync``: see ``run_layer_stack``."""
    if cp_mesh is not None:
        topo = cp_mesh
    cp = _context_parallel(topo)
    tp = _tensor_parallel(topo, None if cp is not None else sp_axis)
    return _forward(cfg, params, input_ids, tp, grad_sync, cp, topo)


class _SeqMean(torch.autograd.Function):
    """The mean of a scalar over the ``sp`` ranks; each rank's gradient
    of the (replicated) mean is 1/n of the upstream one."""

    @staticmethod
    def forward(ctx, x, group):
        n, _ = dcoll.group_rank(group)
        ctx.n = n
        return dcoll._all_reduce(x.clone(), op="avg", group=group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def seq_mean(x, cp):
    """``x`` averaged over the context-parallel ranks (identity without)."""
    return x if cp is None else _SeqMean.apply(x, cp)


def loss_fn(cfg: LlamaConfig, params, batch, sp_axis=None, cp_mesh=None,
            *, topo=None, grad_sync=None):
    """Mean next-token cross-entropy over every token (no ignore index),
    in the reference's logsumexp form: (total, ce), total = ce + 0.01 x
    the MoE aux loss (reference llama.py:527-539).  Under tensor
    parallelism the
    cross-entropy is vocab-parallel (``tensor_parallel.cross_entropy``):
    no rank builds the full logits.  Under context parallelism (sp > 1;
    see ``forward_pure``) each rank's mean over its block is averaged
    over the ``sp`` ranks, so the value is the mean over the whole
    sequence; each rank's gradient is its share, and the sum of the
    ranks' gradients the gradient of the mean.  The aux is the global
    batch's on every rank, its gradient shared out the same way
    (``distributed.expert_parallel``)."""
    if cp_mesh is not None:
        topo = cp_mesh
    cp = _context_parallel(topo)
    tp = _tensor_parallel(topo, None if cp is not None else sp_axis)
    logits, aux = _forward(cfg, params, batch["input_ids"], tp, grad_sync,
                           cp, topo)
    labels = batch["labels"]
    if cp is not None:
        blk = (topo or dmesh.get_topology()).sequence_block(labels.shape[1])
        labels = labels[:, blk.start:blk.stop]
    ce = seq_mean(_ce(logits, labels, tp), cp)
    return (ce + 0.01 * aux if cfg.moe_num_experts else ce), ce


# ---------------------------------------------------------------------------
# the hybrid-parallel train step (reference llama.py:803-1033)
# ---------------------------------------------------------------------------

def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Which axis each dimension of each leaf splits over (None: not
    split), the reference's PartitionSpecs (llama.py:165-200) as
    tuples: column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up``
    and ``lm_head`` (output dim over mp), row-parallel ``wo``/``w_down``
    (input dim over mp), vocab-parallel ``embed``, the leading layer
    axis over pp.  Under MoE the experts split over dp (expert
    parallelism), each expert column / row parallel over mp, and the
    router is whole on every rank."""
    col, row, norm = ("pp", None, "mp"), ("pp", "mp", None), ("pp", None)
    layers = {"ln1": norm, "wq": col, "wk": col, "wv": col, "wo": row,
              "ln2": norm}
    if cfg.moe_num_experts > 0:
        layers.update(router=("pp", None, None),
                      w_gate=("pp", "dp", None, "mp"),
                      w_up=("pp", "dp", None, "mp"),
                      w_down=("pp", "dp", "mp", None))
    else:
        layers.update(w_gate=col, w_up=col, w_down=row)
    return {"embed": ("mp", None), "layers": layers, "norm_f": (None,),
            "lm_head": (None, "mp")}


def _paths(tree, prefix=""):
    """{"embed": ..., "layers/wq": ...}: the leaves by path, in the
    tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _map_specs(fn, tree, specs):
    return {k: (_map_specs(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in tree.items()}


def _chunk_rows(L: int, pp: int, v: int, chunks):
    """The layer rows of the given global chunks of an interleaved
    layout (``pp * v`` chunks of ``L / (pp * v)`` layers), in order."""
    if L % (pp * v):
        raise ValueError(f"{L} layers do not split into pp={pp} x "
                         f"virtual_pp={v} chunks")
    n = L // (pp * v)
    return [r for g in chunks for r in range(g * n, (g + 1) * n)]


def shard_params(cfg: LlamaConfig, params, topo=None, *, device=None,
                 virtual_pp=None):
    """This rank's shards of full params (numpy arrays or tensors; the
    topology ``topo``, else ``init_mesh``'s) on ``device`` (the card
    unless the caller names another), by ``param_specs``.  A split leaf
    is a copy of its block, so the full params can be freed; a leaf
    nothing splits is the input itself when that is a tensor already on
    the device.  ``virtual_pp`` = v > 1 (the interleaved schedule): pp
    rank ``d`` holds the layers of global chunks ``d, pp + d, ...,
    (v - 1) pp + d`` in that order (the reference's reorder of the layer
    axis, ``pipeline.py:373-385``, done once here)."""
    if topo is None:
        topo = dmesh.get_topology()
    dev = resolve_device(device)
    v = virtual_pp or 1

    def shard(leaf, spec):
        split = False
        for dim, axis in enumerate(spec):
            n = topo.dims[axis] if axis else 1
            if n == 1:
                continue
            if leaf.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does "
                                 f"not split over {axis}={n}")
            b = leaf.shape[dim] // n
            k = topo.coords[axis]
            if axis == "pp" and v > 1:
                leaf = leaf[_chunk_rows(leaf.shape[0], n, v,
                                        [c * n + k for c in range(v)])]
            else:
                leaf = leaf[(slice(None),) * dim
                            + (slice(k * b, (k + 1) * b),)]
            split = True
        if not torch.is_tensor(leaf):
            return convert._tensor(leaf, dev)
        leaf = leaf.detach().to(dev)
        return leaf.clone(memory_format=torch.contiguous_format) if split \
            else leaf

    return _map_specs(shard, params, param_specs(cfg))


def gather_params(cfg: LlamaConfig, params, topo=None, *,
                  virtual_pp=None):
    """Full params as numpy arrays from every rank's shards (collective
    over mp and pp: every rank calls it), layers in global order (the
    interleaved layout of ``virtual_pp`` undone).  bf16 leaves come back
    as float32 (numpy has no bfloat16; every bf16 value is a float32
    value)."""
    if topo is None:
        topo = dmesh.get_topology()
    v = virtual_pp or 1

    def gather(t, spec):
        t = t.detach()
        for dim, axis in enumerate(spec):
            if axis:
                t = dcoll._all_gather(t, topo.group(axis), dim=dim)
                n = topo.dims[axis]
                if axis == "pp" and v > 1:
                    # position (d, c) holds global chunk c * pp + d
                    t = t[_chunk_rows(t.shape[0], n, v,
                                      [(g % n) * v + g // n
                                       for g in range(n * v)])]
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_specs(gather, params, param_specs(cfg))


def adamw(tensors):
    """The train step's optimizer: optax ``adamw(3e-4, b1=0.9, b2=0.95,
    weight_decay=0.1)`` (every leaf decays, moments in the param
    dtype)."""
    return torch.optim.AdamW(tensors, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.1)


def build_train_step(cfg: LlamaConfig, topo=None, optimizer=None,
                     use_pp=None, n_microbatches=None, zero=True,
                     schedule="gpipe", virtual_pp=None, overlap=False,
                     device=None):
    """The full training step over the hybrid topology (``topo``, else
    ``init_mesh``'s), on ``device`` (the card unless the caller names
    another; the process group's backend must take its tensors).
    Returns ``(step_fn, init_fn)``:

    - ``init_fn(seed=0, *, params=None)`` -> ``(params, opt_state)``:
      every rank draws the same full params from a generator seeded
      with ``seed`` (``init_params``), keeps its shards and frees the
      rest; or starts from ``params``, this rank's shards
      (``shard_params``, with ``virtual_pp=step_fn.virtual_pp`` under
      the interleaved schedule).  ``opt_state`` is a ``ZeroOptimizer``.
    - ``step_fn(params, opt_state, batch)`` -> ``(params, opt_state,
      {"loss", "ce"})``: ``batch`` is this rank's rows of the global
      batch (``step_fn.shard_batch``: ``topo.shard_batch`` by
      microbatch under the pipeline, so that a rank's microbatch ``m``
      is its share of the global microbatch ``m``, as the reference
      splits the global batch; the ``pp`` and ``sp`` ranks of a row set
      take the same rows); the params and the state are updated in
      place and returned.  The loss is the mean over every token of the
      global batch, as the reference's ``jnp.mean``, plus 0.01 x the
      MoE aux loss.

    Without a pipeline the forward is the reference's ``loss_fn(...,
    sp_axis="mp")``: tensor parallel with sequence-parallel activations
    over mp; under sp > 1 context parallel (ring attention, no
    sequence-parallel activations), as the reference's ``cp_mesh``
    branch.  Each rank's loss is scaled by 1/(dp x sharding) so that the
    gradients' sum over the batch axes (and sp) is the global mean's.
    ZeRO-1 over the zero axis (``zero=True``; ``distributed.zero``)
    inside each pipeline stage.  ``overlap=True`` on a pure
    data-parallel topology (dp > 1, mp = sharding = sp = 1, no pipeline,
    as the reference, llama.py:876-880) reduces each layer's gradients
    inside the backward (``reduce_in_backward``) and the tail in 4 MiB
    buckets (``bucketed_psum``); with ``schedule="1f1b"`` it runs the
    overlapped 1F1B schedule; other topologies, and MoE models (as in
    the reference), ignore it.  Under MoE the experts split over dp
    (``param_specs``): an expert leaf's gradient is summed over the
    batch axes but dp (``distributed.zero``), and the router's, which
    every mp rank computes a part of, over mp.

    ``use_pp`` (default: pp > 1) runs the pipeline over ``pp``
    (``distributed.pipeline``) with ``n_microbatches`` (default pp)
    microbatches of this rank's rows: ``schedule`` "gpipe" (context
    parallelism runs inside it under sp > 1), "1f1b" or "interleaved"
    (``virtual_pp`` chunks a rank; default 2 where the layers split so,
    else 1).  The embedding, final norm and head are whole on every
    stage; their gradients are summed over ``pp``, so their replicas
    stay the same bits.  ``optimizer``: a factory from a list of
    tensors to a ``torch.optim`` optimizer (default ``adamw``)."""
    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}; expected 'gpipe', "
            "'1f1b' or 'interleaved'")
    if virtual_pp is not None and schedule != "interleaved":
        raise ValueError(
            "virtual_pp only applies to schedule='interleaved'")
    if topo is None:
        topo = dmesh.get_topology()
    dev = resolve_device(device)
    pp, mp = topo.pp_degree, topo.mp_degree
    use_pp = (pp > 1) if use_pp is None else bool(use_pp)
    if pp > 1 and not use_pp:
        raise ValueError(f"pp={pp} shards the layers over stages: it "
                         "needs the pipeline (use_pp)")
    cp = topo.sp_degree > 1
    if use_pp and cp and schedule != "gpipe":
        raise ValueError(
            "context parallelism (sp > 1) composes with pipeline "
            "parallelism on the GPipe schedule only (ring attention "
            "inside the pp x sp shard_map); use schedule='gpipe' or "
            "drop one axis")
    _check_tensor_parallel(cfg, mp, topo.dp_degree)
    n_micro = n_microbatches or pp
    v = None
    if use_pp and schedule == "interleaved":
        v = virtual_pp or (2 if cfg.num_hidden_layers % (pp * 2) == 0
                           else 1)
    specs = _paths(param_specs(cfg))
    make_optimizer = optimizer or adamw
    n_batch = topo.axis_size(topo.batch_axes)
    overlap_dp = (overlap and not use_pp and not cp and topo.dp_degree > 1
                  and mp == 1 and topo.sharding_degree == 1
                  and cfg.moe_num_experts == 0)
    # leaves every mp rank holds whole: under sequence parallelism each
    # rank's gradient of them comes from its own S/mp rows; the MoE
    # router's from the mp ranks' partial expert outputs (``_moe_mlp``)
    seq_par = mp > 1 and not use_pp and not cp
    mp_partial = [p for p, s in specs.items() if "mp" not in s] \
        if seq_par else []
    if mp > 1 and cfg.moe_num_experts > 0 and not seq_par:
        mp_partial.append("layers/router")
    tail = [k for k in param_specs(cfg) if k != "layers"]

    def init_fn(seed: int = 0, *, params=None):
        if params is None:
            full = init_params(cfg, seed, device=dev)
            params = shard_params(cfg, full, topo, device=dev,
                                  virtual_pp=v)
            del full
        flat = _paths(params)
        for t in flat.values():
            t.requires_grad_(True)
        return params, ZeroOptimizer(flat, specs, topo, make_optimizer,
                                     zero=zero)

    def loss_and_grads(params, batch):
        """(total, ce) with every parameter's gradient (its part) set."""
        if use_pp and schedule == "1f1b":
            total, ce, grads = dpipe.pipeline_1f1b_value_and_grad(
                cfg, topo, n_micro, params, batch, overlap=overlap,
                scale=1.0 / n_batch)
            for path, g in _paths(grads).items():
                _paths(params)[path].grad = g
            return total, ce
        reducer = doverlap.Reducer(topo.group("dp")) if overlap_dp else None
        if use_pp and schedule == "interleaved":
            total, ce = dpipe.pipeline_interleaved_loss_fn(
                cfg, topo, n_micro, v, params, batch)
        elif use_pp:
            total, ce = dpipe.pipeline_loss_fn(
                cfg, topo, n_micro, params, batch,
                cp_axis="sp" if cp else None)
        else:
            total, ce = loss_fn(cfg, params, batch, sp_axis="mp",
                                topo=topo, grad_sync=reducer)
        (total / n_batch if n_batch > 1 else total).backward()
        if reducer is not None:
            reducer.wait_all()
            reduced = doverlap.bucketed_psum(
                {k: params[k].grad for k in tail}, reducer.group)
            for k, g in reduced.items():
                params[k].grad = g
        if use_pp:
            # the embedding's gradient is stage 0's, the head's the last
            # stage's: the sum gives every stage both, the same bits
            for k in tail:
                if params[k].grad is None:
                    params[k].grad = torch.zeros_like(params[k])
                dcoll._all_reduce(params[k].grad, group=topo.group("pp"))
        return total, ce

    def step_fn(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        total, ce = loss_and_grads(params, batch)
        flat = _paths(params)
        for path in mp_partial:
            dcoll._all_reduce(flat[path].grad, group=topo.group("mp"))
        opt_state.step(reduced=overlap_dp)
        loss = torch.stack([total.detach(), ce.detach()])
        if n_batch > 1:
            dcoll._all_reduce(loss, op="avg", group=topo.group(
                topo.batch_axes))
        return params, opt_state, {"loss": loss[0], "ce": loss[1]}

    def shard_batch(batch):
        return topo.shard_batch(batch, microbatches=n_micro if use_pp
                                else 1)

    step_fn.topology = topo
    step_fn.shard_batch = shard_batch
    step_fn.overlap = overlap_dp
    step_fn.schedule = schedule if use_pp else None
    step_fn.n_microbatches = n_micro if use_pp else None
    step_fn.virtual_pp = v
    return step_fn, init_fn


# ---------------------------------------------------------------------------
# KV-cache generation (models/decoding.py; reference llama.py:546-797)
# ---------------------------------------------------------------------------

def forward_with_cache(cfg: LlamaConfig, params, tokens, cache, pos: int):
    """Chunked cached forward: ``tokens`` [B, T] starting at sequence
    offset ``pos`` against the dense per-layer caches (``cache``, a
    ``decoding.KVCache``, updated in place).  Dense configs run the math
    of the unfused ``forward_pure`` (rope at absolute positions, the
    cache at kv-head width); attention is ``cached_attention_core``
    (plain, f32), never flash.  Every matmul of an int8
    ``quantize_params`` leaf, the head's too, goes through the int8
    matmul (``_qmm``): a llama7b step launches it 7 L + 1 times.  MoE
    layers route the chunk's own tokens with a capacity computed from
    them (``_moe_mlp`` on the chunk, reference llama.py:551-555), so a
    one-token step is dropless, unlike the training forward.  Serves
    both prefill (T = prompt) and decode (T = 1).  Returns (logits
    [B, T, V] f32, cache)."""
    B, T = tokens.shape
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    H, eps = cfg.hidden_size, cfg.rms_norm_eps
    embed = params["embed"]
    dev = embed.device
    sin_full, cos_full = _rope_tables(cfg, cfg.max_position_embeddings, dev)
    sin, cos = sin_full[pos:pos + T], cos_full[pos:pos + T]
    h = embed[tokens.to(dev).long()]
    layers = params["layers"]
    for l in range(cfg.num_hidden_layers):
        lp = {k: _layer(v, l) for k, v in layers.items()}
        xn = _rms_norm(h, lp["ln1"], eps)
        q = _apply_rope(_qmm(xn, lp["wq"]).reshape(B, T, nh, d), sin, cos)
        k = _apply_rope(_qmm(xn, lp["wk"]).reshape(B, T, nkv, d), sin, cos)
        v = _qmm(xn, lp["wv"]).reshape(B, T, nkv, d)
        out, _, _ = decoding.cached_attention_core(q, k, v, cache.k[l],
                                                   cache.v[l], pos)
        h = h + _qmm(out.reshape(B, T, H), lp["wo"])
        hn = _rms_norm(h, lp["ln2"], eps)
        if cfg.moe_num_experts > 0:
            h = h + _moe_mlp(cfg, lp, hn)[0]
        else:
            h = h + _dense_mlp(lp, hn)
    x = _rms_norm(h, params["norm_f"], eps)
    return _qmm(x, params["lm_head"]).float(), cache


def generate(cfg: LlamaConfig, params, input_ids, max_new_tokens,
             temperature=0.0, top_k=0, rng=None, eos_token_id=None):
    """[B, P] prompt -> [B, max_new_tokens] continuations (int64) on the
    params' device; ``rng``: an int seed or a ``torch.Generator`` there.
    The reference memoises one compiled scan a signature (``_RUN_CACHE``,
    ``_cfg_key``); the port's loop is eager and has none."""
    return decoding.model_generate(
        lambda p, t, c, pos: forward_with_cache(cfg, p, t, c, pos),
        num_layers=cfg.num_hidden_layers,
        kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        max_positions=cfg.max_position_embeddings,
        cache_dtype=cfg.dtype,
        device=params["embed"].device, params=params, input_ids=input_ids,
        max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, rng=rng, eos_token_id=eos_token_id)


# ---------------------------------------------------------------------------
# the eager class (reference llama.py:1038-1109)
# ---------------------------------------------------------------------------

def _flatten_params(tree, prefix=""):
    """[(dotted name, leaf)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(_flatten_params(v, name))
        else:
            out.append((name, v))
    return out


def _unflatten_params(flat):
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class _StackedLayer(Layer):
    """An eager ``Layer`` over a functional core: the stacked parameter
    tree's leaves are its ``Parameter``s under the reference facade's
    names (``name.replace(".", "_")``: ``state_dict()`` keys equal the
    reference's), built on the current place.  ``forward`` runs the core
    inside one op over the parameters' own tensors, so on the card it
    launches the core's kernels, its logits are the core's bits and both
    uses of a tied weight accumulate on one ``.grad``."""

    def _register_tree(self, raw):
        self._names = []
        for name, t in _flatten_params(raw):
            self.add_parameter(name.replace(".", "_"), Parameter(
                t, trainable=t.is_floating_point(), name=name))
            self._names.append(name)

    def _params(self):
        return [self._parameters[n.replace(".", "_")] for n in self._names]

    def _tree(self):
        return _unflatten_params({n: p._t for n, p in
                                  zip(self._names, self._params())})

    def _forward(self, core, input_ids, labels, op_name):
        """``core(tree, ids) -> logits`` as one op; with ``labels``:
        (mean cross-entropy over every token, logits), the reference's
        ``F.cross_entropy`` over [-1, V]."""
        from ..nn import functional as NF
        from ..tensor.manipulation import reshape
        params = self._params()
        names = self._names
        dev = params[0]._t.device
        ids = input_ids if isinstance(input_ids, Tensor) \
            else to_tensor(input_ids, place=dev)

        def _f(ids_t, *arrs):
            return core(_unflatten_params(dict(zip(names, arrs))),
                        ids_t.to(dev))
        logits = apply_op(_f, ids, *params, op_name=op_name)
        if labels is None:
            return logits
        if not isinstance(labels, Tensor):
            labels = to_tensor(labels, place=dev)
        V = logits.shape[-1]
        loss = NF.cross_entropy(reshape(logits, [-1, V]),
                                reshape(labels, [-1]))
        return loss, logits


class LlamaForCausalLM(decoding.GenerationMixin, _StackedLayer):
    """The eager class: parameters are ``init_params(config, 0)`` on the
    current place, and ``forward(ids, labels=None)`` is ``forward_pure``
    over them, so on the card it launches the fused decoder blocks as
    the train step does and its logits are ``forward_pure``'s bits."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self._register_tree(init_params(config, 0, device=current_device()))

    def forward(self, input_ids, labels=None):
        cfg = self.config
        return self._forward(lambda tree, ids: forward_pure(cfg, tree, ids)[0],
                             input_ids, labels, "llama_forward")


LlamaForCausalLM._generate_fn = staticmethod(generate)
