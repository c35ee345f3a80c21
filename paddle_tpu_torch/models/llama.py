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
  (``ops.flash_attention.causal_attention``).  MoE and context
  parallelism raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..ops import fused_blocks as fb
from ..ops.flash_attention import causal_attention
from ..ops.int8_matmul import int8_matmul, quantize_int8
from ..ops.ragged_paged_attention import ragged_paged_attention

__all__ = ["LlamaConfig", "PRESETS", "preset", "init_params",
           "quantize_params", "forward_paged", "decoder_layer",
           "run_layer_stack", "forward_pure", "loss_fn"]


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
    # MoE is not ported yet: any value > 0 makes forward_paged raise
    moe_num_experts: int = 0
    # int8 weight path: "auto" (or None) = on CUDA only, "on" =
    # everywhere (the CPU runs the plain int8 version, what parity tests
    # use), "off" = dense weights
    quantized: Optional[str] = None
    # training: remat per layer; "full" recomputes the whole layer in the
    # backward, "dots" saves the matmul outputs and recomputes the rest
    use_remat: bool = True
    remat_policy: str = "dots"
    # fused decoder blocks: "auto" (or None) = on CUDA tensors only, "on"
    # = on any device (the CPU runs the plain versions, what parity tests
    # use), "off" = the unfused composition; see _fused_block_modes
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
    holds more than one layer's weight."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP A2: distributed train "
            "runtime, _moe_mlp)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    V = cfg.vocab_size
    KV = cfg.num_key_value_heads * cfg.head_dim
    std = 0.02

    def init(shape):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * std)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": init((V, H)),
        "layers": {
            "ln1": ones((L, H)),
            "wq": init((L, H, H)),
            "wk": init((L, H, KV)),
            "wv": init((L, H, KV)),
            "wo": init((L, H, H)),
            "ln2": ones((L, H)),
            "w_gate": init((L, H, I)),
            "w_up": init((L, H, I)),
            "w_down": init((L, I, H)),
        },
        "norm_f": ones((H,)),
        "lm_head": init((H, V)),
    }


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


def _quantized_mode(cfg: LlamaConfig, device) -> bool:
    """Resolved int8-weight policy: "auto" (the default) quantizes on
    CUDA only; "on" everywhere; "off" never."""
    mode = cfg.quantized or "auto"
    if mode == "off":
        return False
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return True


# weight leaves quantize_params converts (per-layer stacked [L, K, N]);
# norms and embed stay dense
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


def quantize_params(cfg: LlamaConfig, params):
    """PTQ the serving weight path to int8: each matmul weight in
    ``_QUANT_WEIGHTS`` plus ``lm_head`` becomes a ``{"q", "scale"}``
    leaf (per-output-channel absmax, ``quantize_int8``).  Idempotent:
    already-quantized leaves pass through."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet")
    out = dict(params)
    layers = dict(params["layers"])
    for nm in _QUANT_WEIGHTS:
        w = layers.get(nm)
        if w is not None and not isinstance(w, dict):
            layers[nm] = _quantize_stacked(w)
    out["layers"] = layers
    head = out.get("lm_head")
    if head is not None and not isinstance(head, dict):
        q, scale = quantize_int8(head)
        out["lm_head"] = {"q": q, "scale": scale}
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
    step needs."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP A2: distributed train "
            "runtime, _moe_mlp)")
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
# the train half: forward_pure -> loss_fn (single device, unfused blocks)
# ---------------------------------------------------------------------------

def _apply_rope(x, sin, cos):
    """Neox rope on x [B, S, H, D] with tables [S, D], cast to x's dtype
    before the multiply as the reference does."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[None, :, None, :].to(x.dtype)
            + rot * sin[None, :, None, :].to(x.dtype))


def _attention(cfg: LlamaConfig, lp, x, sin, cos):
    """Self-attention of one layer (the reference's non-context-parallel
    branch): qkv projections, rope, GQA kv-head repeat (``jnp.repeat``
    = ``repeat_interleave``), causal flash attention, output
    projection."""
    B, S, H = x.shape
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    q = _apply_rope(_qmm(x, lp["wq"]).reshape(B, S, nh, d), sin, cos)
    k = _apply_rope(_qmm(x, lp["wk"]).reshape(B, S, nkv, d), sin, cos)
    v = _qmm(x, lp["wv"]).reshape(B, S, nkv, d)
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = causal_attention(q, k, v)
    return _qmm(out.reshape(B, S, H), lp["wo"])


def _fused_block_modes(cfg: LlamaConfig, x):
    """(use_fused_attention, use_fused_mlp) for the activation ``x``
    (reference llama.py:405-430).  ``fused_blocks`` None means "auto",
    the reference flag's default: "auto" engages on CUDA tensors only,
    "on" on any device, "off" never.  The fused attention block also
    needs as many kv heads as heads and a head dim the flash kernels
    take; the fused MLP needs no MoE; both need the kernels' shapes
    (``fused_blocks.fused_*_ok``)."""
    mode = cfg.fused_blocks or "auto"
    if mode == "off" or (mode == "auto" and x.device.type != "cuda"):
        return False, False
    H = cfg.hidden_size
    attn_ok = (cfg.num_key_value_heads == cfg.num_attention_heads
               and fb.fused_attention_ok(H, cfg.head_dim))
    mlp_ok = (cfg.moe_num_experts == 0
              and fb.fused_mlp_ok(H, cfg.intermediate_size))
    return attn_ok, mlp_ok


def decoder_layer(cfg: LlamaConfig, lp, x, sin, cos):
    """One decoder block on a per-layer param slice (no leading L axis):
    the fused blocks where ``_fused_block_modes`` engages them, else the
    unfused dense composition (reference llama.py:433-465).  It returns
    the hidden state alone; the reference's MoE aux loss comes with MoE
    (ROADMAP A2)."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP A2: distributed train "
            "runtime, _moe_mlp)")
    fused_attn, fused_mlp = _fused_block_modes(cfg, x)
    if isinstance(lp.get("wq"), dict) or isinstance(lp.get("w_gate"), dict):
        # int8 quantize_params leaves: the fused kernels take dense
        # weights, so quantized layers take the unfused composition
        fused_attn = fused_mlp = False
    eps = cfg.rms_norm_eps
    if fused_attn:
        h = fb.fused_attention_block(x, lp["ln1"], lp["wq"], lp["wk"],
                                     lp["wv"], lp["wo"], sin, cos,
                                     head_dim=cfg.head_dim, eps=eps)
    else:
        h = x + _attention(cfg, lp, _rms_norm(x, lp["ln1"], eps), sin, cos)
    if fused_mlp:
        return fb.fused_mlp_block(h, lp["ln2"], lp["w_gate"], lp["w_up"],
                                  lp["w_down"], eps=eps)
    return h + _dense_mlp(lp, _rms_norm(h, lp["ln2"], eps))


# matmul ops whose outputs the "dots" policy keeps (jax's dots_saveable)
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default]


def _dots_context():
    return create_selective_checkpoint_contexts(_DOT_OPS)


def run_layer_stack(cfg: LlamaConfig, stacked, x, sin, cos):
    """The layers in a Python loop (the reference's ``lax.scan``); returns
    the hidden state.

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
    so checkpoint's saved-tensor metadata check holds.

    The stacked leaves are split with one ``unbind`` each, whose
    backward writes every layer's gradient into one stacked tensor (a
    per-layer index would add a full-size zero tensor per layer)."""
    names = list(stacked)
    L = stacked[names[0]].shape[0]
    per_layer = [dict(zip(names, parts)) for parts in
                 zip(*(stacked[n].unbind(0) for n in names))]

    def layer(lp, h):
        return decoder_layer(cfg, lp, h, sin, cos)

    for l in range(L):
        lp = per_layer[l]
        if not cfg.use_remat:
            x = layer(lp, x)
        elif cfg.remat_policy == "full":
            x = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x = checkpoint(layer, lp, x, use_reentrant=False,
                           context_fn=_dots_context)
    return x


def forward_pure(cfg: LlamaConfig, params, input_ids, sp_axis=None,
                 cp_mesh=None):
    """Full forward: ids [B, S] -> logits [B, S, V] f32.  Runs on the
    device the params are on; sequence and context parallelism are not
    ported (ROADMAP A2) and raise."""
    if sp_axis is not None or cp_mesh is not None:
        raise NotImplementedError(
            "sequence and context parallelism are not ported yet (ROADMAP "
            "A2: distributed train runtime, ring attention)")
    if isinstance(params["lm_head"], dict):
        raise NotImplementedError("training takes dense weights, not "
                                  "quantize_params leaves")
    embed = params["embed"]
    S = input_ids.shape[1]
    sin, cos = _rope_tables(cfg, S, embed.device)
    x = F.embedding(input_ids.to(embed.device).long(), embed)
    x = run_layer_stack(cfg, params["layers"], x, sin, cos)
    x = _rms_norm(x, params["norm_f"], cfg.rms_norm_eps)
    return _qmm(x, params["lm_head"]).float()


def loss_fn(cfg: LlamaConfig, params, batch, sp_axis=None, cp_mesh=None):
    """Mean next-token cross-entropy over every token (no ignore index),
    in the reference's logsumexp form: (total, ce).  With no MoE aux
    loss ported, total is ce."""
    logits = forward_pure(cfg, params, batch["input_ids"], sp_axis, cp_mesh)
    labels = batch["labels"].to(logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    ce = (lse - tgt).mean()
    return ce, ce
