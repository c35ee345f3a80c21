"""ERNIE-style encoder pretraining (the port of
``paddle_tpu/models/ernie.py``, the BASELINE.json "ERNIE-3.0 pretrain"
configuration): a post-LN bidirectional encoder with an additive
padding mask, the MLM head tied to the word embedding, and the
next-sentence head; the objective MLM + NSP.

The same stacked-tree design as ``models/llama.py``: layer leaves carry
a leading ``[L]`` axis, ``param_specs`` gives the Megatron contract over
``mp`` in the port's spec form (one axis name or None a dimension), and
``build_pretrain_step`` trains over the port's ``HybridTopology``:

- mp (``distributed.tensor_parallel``): q/k/v and ``w1`` are column
  parallel (their biases split with them), ``wo`` and ``w2`` row
  parallel (their biases added after the sum), the word embedding
  vocab-parallel, and so is the tied MLM decoder with ``mlm_bias``: the
  MLM logits stay split by vocab and their per-token loss is the
  vocab-parallel cross-entropy.  ``pooler_w`` and ``mlm_trans_w`` are
  column parallel; their outputs are gathered whole (the next sentence
  head and the MLM head's LayerNorm need every column).
- dp: each rank takes its rows (``step_fn.shard_batch``); its loss is
  its share of the global batch's (its sums over the global counts), so
  the sum of the ranks' gradients, which the port's gradient all-reduce
  takes (``ZeroOptimizer`` with ``zero=False``: the reference keeps
  whole optimizer states), is the global batch's gradient.
- pp: each pp rank holds its ``L/pp`` layers of every stacked leaf and
  their optimizer state, and gathers the stack before the forward
  (``tensor_parallel.gather`` over pp); the pp ranks run the same
  forward on the same rows, so each keeps its slice of the stack's
  gradient.
- sharding and sp: in no spec, so their ranks run replicated, with the
  rows split over dp only, as the reference's ``P("dp", None)``.

Attention is plain PyTorch, as the reference's is jnp: no TPU kernel
sits under it (the flash kernels are causal only).  GELU is the tanh
form (``jax.nn.gelu``'s default), the variance the population one, the
mask bias -1e9 in the activation dtype, the softmax in f32 cast back,
and ``_ln`` divides by ``sqrt(var + eps)`` (no rsqrt) in f32 before the
cast: the reference's order.  The default dtype is float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed import collective as dcoll
from ..distributed import mesh as dmesh
from ..distributed import tensor_parallel as tpar
from ..distributed.zero import ZeroOptimizer
from . import convert
from .llama import _map_specs, _paths, _tensor_parallel

__all__ = ["ErnieConfig", "init_params", "param_specs", "shard_params",
           "forward_pure", "pretrain_loss", "build_pretrain_step"]


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def init_params(cfg: ErnieConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """The parameter dict drawn N(0, 0.02) in f32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless the caller names another), then cast; biases zero, norms
    one."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    V, std = cfg.vocab_size, 0.02

    def init(shape):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "wq": init((L, H, H)), "wk": init((L, H, H)),
        "wv": init((L, H, H)), "wo": init((L, H, H)),
        "w1": init((L, H, I)), "w2": init((L, I, H)),
        "b_q": zeros((L, H)), "b_k": zeros((L, H)), "b_v": zeros((L, H)),
        "b_o": zeros((L, H)), "b_1": zeros((L, I)), "b_2": zeros((L, H)),
        "ln1_w": ones((L, H)), "ln1_b": zeros((L, H)),
        "ln2_w": ones((L, H)), "ln2_b": zeros((L, H)),
    }
    return {
        "word_emb": init((V, H)),
        "pos_emb": init((cfg.max_position_embeddings, H)),
        "type_emb": init((cfg.type_vocab_size, H)),
        "emb_ln_w": ones((H,)), "emb_ln_b": zeros((H,)),
        "layers": layers,
        "pooler_w": init((H, H)), "pooler_b": zeros((H,)),
        "mlm_trans_w": init((H, H)), "mlm_trans_b": zeros((H,)),
        "mlm_ln_w": ones((H,)), "mlm_ln_b": zeros((H,)),
        "mlm_bias": zeros((V,)),
        "nsp_w": init((H, 2)), "nsp_b": zeros((2,)),
    }


def param_specs(cfg: ErnieConfig) -> Dict[str, Any]:
    """Which axis each dimension of each leaf splits over (None: not
    split), the reference's PartitionSpecs (ernie.py:99-123) as tuples:
    column-parallel ``wq``/``wk``/``wv``/``w1`` with their biases,
    row-parallel ``wo``/``w2``, the layer axis over pp, vocab-parallel
    ``word_emb`` and ``mlm_bias``, column-parallel ``pooler_w`` and
    ``mlm_trans_w`` with their biases."""
    col, row = ("pp", None, "mp"), ("pp", "mp", None)
    vec, vec_mp = ("pp", None), ("pp", "mp")
    layers = {
        "wq": col, "wk": col, "wv": col, "wo": row, "w1": col, "w2": row,
        "b_q": vec_mp, "b_k": vec_mp, "b_v": vec_mp, "b_o": vec,
        "b_1": vec_mp, "b_2": vec,
        "ln1_w": vec, "ln1_b": vec, "ln2_w": vec, "ln2_b": vec,
    }
    return {
        "word_emb": ("mp", None),
        "pos_emb": (None, None), "type_emb": (None, None),
        "emb_ln_w": (None,), "emb_ln_b": (None,),
        "layers": layers,
        "pooler_w": (None, "mp"), "pooler_b": ("mp",),
        "mlm_trans_w": (None, "mp"), "mlm_trans_b": ("mp",),
        "mlm_ln_w": (None,), "mlm_ln_b": (None,),
        "mlm_bias": ("mp",),
        "nsp_w": (None, None), "nsp_b": (None,),
    }


def _check_mp(cfg: ErnieConfig, mp: int):
    for what, n in (("num_attention_heads", cfg.num_attention_heads),
                    ("hidden_size", cfg.hidden_size),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % mp:
            raise ValueError(f"{what}={n} does not split over mp={mp}")


def shard_params(cfg: ErnieConfig, params, topo=None, *, device=None):
    """This rank's blocks of full params (numpy arrays or tensors) on
    ``device`` (the card unless the caller names another), by
    ``param_specs`` over the topology (``topo``, else ``init_mesh``'s);
    each a copy, so the full params can be freed."""
    if topo is None:
        topo = dmesh.get_topology()
    _check_mp(cfg, topo.mp_degree)
    dev = resolve_device(device)

    def shard(leaf, spec):
        t = leaf if torch.is_tensor(leaf) else convert._tensor(leaf, "cpu")
        for dim, axis in enumerate(spec):
            n = topo.dims[axis] if axis else 1
            if n > 1:
                b = t.shape[dim] // n
                t = t.narrow(dim, topo.coords[axis] * b, b)
        return t.detach().to(dev).clone(memory_format=torch.contiguous_format)

    return _map_specs(shard, params, param_specs(cfg))


def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype) * w + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _tp_fns(tp):
    """(enter, leave, gather) of a forward: identities without mp."""
    if tp is None:
        ident = (lambda t: t)
        return ident, ident, ident
    return ((lambda t: tpar.enter(t, tp)), (lambda t: tpar.leave(t, tp)),
            (lambda t: tpar.gather(t, tp)))


def _encoder_layer(cfg: ErnieConfig, lp, x, mask_bias, tp):
    B, S, _ = x.shape
    into, out, _ = _tp_fns(tp)
    nh = cfg.num_attention_heads // (1 if tp is None else tp.size)
    d = cfg.head_dim
    xi = into(x)
    q = (xi @ lp["wq"] + lp["b_q"]).reshape(B, S, nh, d)
    k = (xi @ lp["wk"] + lp["b_k"]).reshape(B, S, nh, d)
    v = (xi @ lp["wv"] + lp["b_v"]).reshape(B, S, nh, d)
    logits = torch.einsum("bsnd,btnd->bnst", q, k) / math.sqrt(d)
    logits = logits + mask_bias      # [B, 1, 1, S] additive padding mask
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bnst,btnd->bsnd", probs, v).reshape(B, S, nh * d)
    attn = out(ctx @ lp["wo"]) + lp["b_o"]
    x = _ln(x + attn, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
    mlp = out(_gelu(into(x) @ lp["w1"] + lp["b_1"]) @ lp["w2"]) + lp["b_2"]
    return _ln(x + mlp, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)


def _pipeline(topo):
    """The pp group of a topology with pp > 1 (``topo``, else
    ``init_mesh``'s), as a ``TensorParallel`` record; else None."""
    if topo is None:
        topo = dmesh.get_topology(create=False)
    if topo is None or topo.pp_degree == 1:
        return None
    return tpar.TensorParallel(topo.group("pp"), topo.pp_degree,
                               topo.coords["pp"], False)


def _forward(cfg: ErnieConfig, params, ids, token_type_ids, attention_mask,
             tp, pp=None):
    dev = params["pos_emb"].device
    ids = torch.as_tensor(ids).to(dev).long()
    B, S = ids.shape
    tt = (torch.zeros_like(ids) if token_type_ids is None
          else torch.as_tensor(token_type_ids).to(dev).long())
    am = (torch.ones_like(ids) if attention_mask is None
          else torch.as_tensor(attention_mask).to(dev))
    if tp is None:
        word = F.embedding(ids, params["word_emb"])
    else:
        _check_mp(cfg, tp.size)
        word = tpar.embedding(ids, params["word_emb"], tp)
    x = word + params["pos_emb"][None, :S] + params["type_emb"][tt]
    x = _ln(x, params["emb_ln_w"], params["emb_ln_b"], cfg.layer_norm_eps)
    mask_bias = torch.where(am[:, None, None, :] > 0, 0.0, -1e9).to(x.dtype)
    layers = params["layers"]
    if pp is not None:
        # every pp rank runs the whole stack on the same rows, so each
        # keeps its slice of the stack's gradient (a sum over pp would
        # scale it by pp)
        layers = {n: tpar.gather(t, pp, 0) for n, t in layers.items()}
    names = list(layers)
    parts = {n: layers[n].unbind(0) for n in names}
    for l in range(cfg.num_hidden_layers):
        x = _encoder_layer(cfg, {n: parts[n][l] for n in names}, x,
                           mask_bias, tp)
    into, _, gather = _tp_fns(tp)
    pooled = gather(torch.tanh(into(x[:, 0]) @ params["pooler_w"]
                               + params["pooler_b"]))
    return x, pooled


def forward_pure(cfg: ErnieConfig, params, input_ids, token_type_ids=None,
                 attention_mask=None, *, topo=None):
    """ids [B, S] -> (sequence_output [B, S, H], pooled_output [B, H]) on
    the params' device.  Under a topology with mp or pp > 1 (``topo``,
    else ``init_mesh``'s) the params are this rank's blocks
    (``shard_params``) and both outputs are whole on every rank."""
    return _forward(cfg, params, input_ids, token_type_ids, attention_mask,
                    _tensor_parallel(topo, None), _pipeline(topo))


def _dp_group(topo):
    """The ``dp`` group of a topology with dp > 1 (``topo``, else
    ``init_mesh``'s), else None."""
    if topo is None:
        topo = dmesh.get_topology(create=False)
    if topo is None or topo.dp_degree == 1:
        return None
    return topo.group("dp")


def _loss_parts(cfg: ErnieConfig, params, batch, tp, dp, pp=None):
    """(total, mlm, nsp) of this rank's rows, each this rank's share of
    the global batch's value over the ``dp`` group: the masked MLM sum
    over the global count of labels, the NSP sum over the global
    rows."""
    seq, pooled = _forward(cfg, params, batch["input_ids"],
                           batch.get("token_type_ids"),
                           batch.get("attention_mask"), tp, pp)
    dev = seq.device
    if "masked_positions" in batch:
        pos = torch.as_tensor(batch["masked_positions"]).to(dev).long()
        labels = torch.as_tensor(batch["masked_labels"]).to(dev).long()
        sel = seq.gather(1, pos.clamp_min(0)[..., None].expand(
            -1, -1, seq.shape[-1]))                            # [B, P, H]
    else:
        labels = torch.as_tensor(batch["mlm_labels"]).to(dev).long()
        sel = seq
    into, _, gather = _tp_fns(tp)
    h = gather(_gelu(into(sel) @ params["mlm_trans_w"]
                     + params["mlm_trans_b"]))
    h = _ln(h, params["mlm_ln_w"], params["mlm_ln_b"], cfg.layer_norm_eps)
    # the tied decoder (this rank's vocab block under mp)
    logits = (into(h) @ params["word_emb"].T + params["mlm_bias"]).float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    if tp is None:
        ce = (torch.logsumexp(logits, dim=-1)
              - logits.gather(-1, safe[..., None])[..., 0])
    else:
        ce = tpar.cross_entropy(logits, safe, tp)
    mlm_sum = torch.where(valid, ce, 0.0).sum()
    nsp_logits = (pooled @ params["nsp_w"] + params["nsp_b"]).float()
    nsp_labels = torch.as_tensor(batch["nsp_labels"]).to(dev).long()
    nsp_sum = (torch.logsumexp(nsp_logits, dim=-1)
               - nsp_logits.gather(-1, nsp_labels[:, None])[:, 0]).sum()
    counts = torch.stack([valid.sum(), torch.tensor(
        nsp_labels.shape[0], device=dev)]).float()
    if dp is not None:
        dcoll._all_reduce(counts, group=dp)
    mlm = mlm_sum / counts[0].clamp_min(1)
    nsp = nsp_sum / counts[1]
    return mlm + nsp, mlm, nsp


def pretrain_loss(cfg: ErnieConfig, params, batch, *, topo=None):
    """MLM + NSP loss: (total, {"mlm", "nsp"}).

    ``batch``: input_ids, token_type_ids, attention_mask (both optional),
    nsp_labels [B], and EITHER masked_positions [B, P] + masked_labels
    [B, P] (-1 pads; the reference's pretraining format: the MLM head
    runs on the predicted positions only, gathered at ``max(pos, 0)``)
    OR mlm_labels [B, S] (-1 on unpredicted positions).  The MLM term is
    the mean over the labels >= 0 (0 when there are none); -1 labels
    count nowhere.  Under a topology (``topo``, else ``init_mesh``'s)
    with mp or pp > 1 the params are this rank's blocks; with dp > 1
    ``batch`` is this rank's rows and the values are its shares of the
    global batch's (their sum over dp)."""
    total, mlm, nsp = _loss_parts(cfg, params, batch,
                                  _tensor_parallel(topo, None),
                                  _dp_group(topo), _pipeline(topo))
    return total, {"mlm": mlm, "nsp": nsp}


def adamw(tensors):
    """The pretrain step's optimizer: optax ``adamw(1e-4, b1=0.9,
    b2=0.999, weight_decay=0.01)`` (eps 1e-8, every leaf decays)."""
    return torch.optim.AdamW(tensors, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def build_pretrain_step(cfg: ErnieConfig, topo=None, optimizer=None, *,
                        device=None):
    """The pretrain step over the hybrid topology (``topo``, else
    ``init_mesh``'s), on ``device`` (the card unless the caller names
    another), with the reference's placement: mp splits the leaves by
    ``param_specs``, pp splits the layer stack (each pp rank holds its
    ``L/pp`` layers and their optimizer state, and the step gathers the
    stack over pp before the forward), and the batch's rows split over
    dp only; ``sharding`` and ``sp`` appear in no spec, so their ranks
    hold the same leaves and rows (replicated), as the reference's
    GSPMD step runs there.  Returns ``(step_fn, init_fn)``:

    - ``init_fn(seed=0, *, params=None)`` -> ``(params, opt_state)``:
      every rank draws the same full params (``init_params``) and keeps
      its blocks, or starts from ``params``, its blocks
      (``shard_params``); ``opt_state`` a ``ZeroOptimizer`` with whole
      states (``zero=False``) over this rank's blocks.
    - ``step_fn(params, opt_state, batch)`` -> ``(params, opt_state,
      {"loss", "mlm", "nsp"})`` (global-batch values, every rank):
      ``batch`` is this rank's rows (``step_fn.shard_batch``: the dp
      coordinate's block), in either format of ``pretrain_loss``; the
      gradients are summed over dp, and the params updated in place.

    ``optimizer``: a factory from a list of tensors to a ``torch.optim``
    optimizer (default ``adamw``)."""
    if topo is None:
        topo = dmesh.get_topology()
    _check_mp(cfg, topo.mp_degree)
    if cfg.num_hidden_layers % topo.pp_degree:
        raise ValueError(f"num_hidden_layers={cfg.num_hidden_layers} does "
                         f"not split over pp={topo.pp_degree}")
    dev = resolve_device(device)
    tp = _tensor_parallel(topo, None)
    pp = _pipeline(topo)
    dp = _dp_group(topo)
    specs = _paths(param_specs(cfg))
    make_optimizer = optimizer or adamw

    def init_fn(seed: int = 0, *, params=None):
        if params is None:
            full = init_params(cfg, seed, device=dev)
            params = shard_params(cfg, full, topo, device=dev)
            del full
        flat = _paths(params)
        for t in flat.values():
            t.requires_grad_(True)
        return params, ZeroOptimizer(flat, specs, topo, make_optimizer,
                                     zero=False)

    def shard_batch(batch):
        """This rank's rows: the dp coordinate's block of every leaf."""
        n, i = topo.dp_degree, topo.coords["dp"]
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch of {v.shape[0]} rows does not "
                                 f"split over dp={n}")
            b = v.shape[0] // n
            out[k] = v[i * b:(i + 1) * b]
        return out

    def step_fn(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        total, mlm, nsp = _loss_parts(cfg, params, batch, tp, dp, pp)
        total.backward()
        if dp is not None:
            for t in _paths(params).values():
                dcoll._all_reduce(t.grad, group=dp)
        opt_state.step(reduced=True)
        out = torch.stack([total.detach(), mlm.detach(), nsp.detach()])
        if dp is not None:
            dcoll._all_reduce(out, group=dp)
        return params, opt_state, {"loss": out[0], "mlm": out[1],
                                   "nsp": out[2]}

    step_fn.topology = topo
    step_fn.shard_batch = shard_batch
    return step_fn, init_fn
