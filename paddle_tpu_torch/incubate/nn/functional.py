"""Fused functionals (the port of ``paddle_tpu/incubate/nn/functional.py``;
reference: python/paddle/incubate/nn/functional/).  Each is the
reference's composition of the port's ops; attention goes through
``F.scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch

from ...core.tensor import apply_op
from ...ops.registry import _ensure_tensor
from ...nn.functional.common import _keep_mask, scaled_dot_product_attention

__all__ = ["fused_matmul_bias", "fused_linear", "fused_feedforward",
           "fused_multi_head_attention", "fused_dropout_add",
           "fused_rotary_position_embedding", "swiglu",
           "sparse_attention"]


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    args = [x, y]
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(a, b, *bias_):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = torch.matmul(a, b)
        if bias_:
            out = out + bias_[0]
        return out
    return apply_op(_f, *args, op_name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """reference: incubate/nn/functional/fused_matmul_bias.py
    fused_linear."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def _silu(a):
    return a * torch.sigmoid(a)


def swiglu(x, y=None, name=None):
    """SwiGLU: silu(x) * y, or of x's two halves."""
    x = _ensure_tensor(x)
    if y is None:
        def _f(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return _silu(a1) * a2
        return apply_op(_f, x, op_name="swiglu")
    y = _ensure_tensor(y)
    return apply_op(lambda a, b: _silu(a) * b, x, y, op_name="swiglu")


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    if not training or p == 0:
        return apply_op(torch.add, x, y, op_name="fused_dropout_add")
    keep = _keep_mask(list(x._t.shape), p, x._t.device)

    def _f(a, b):
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        return torch.where(keep, a / (1 - p), zero).to(a.dtype) + b
    return apply_op(_f, x, y, op_name="fused_dropout_add")


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """RoPE on q and k (``v`` passes through); ``sin`` / ``cos`` are
    constants of the op."""
    def rope(t, sin_a, cos_a):
        if use_neox_rotary_style:
            half = t.shape[-1] // 2
            rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
        else:
            rot = torch.stack([-t[..., 1::2], t[..., ::2]],
                              dim=-1).reshape(t.shape)
        return t * cos_a + rot * sin_a

    sin_a = sin._t.detach() if sin is not None else None
    cos_a = cos._t.detach() if cos is not None else None
    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
            continue
        tt = _ensure_tensor(t)
        if t is v:
            outs.append(tt)
            continue
        outs.append(apply_op(lambda a: rope(a, sin_a, cos_a), tt,
                             op_name="rope"))
    return tuple(outs)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-05, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-05,
                               training=True, mode='upscale_in_train',
                               ring_id=-1, num_heads=None, name=None):
    """The monolithic attention block (reference: fused_attention_op.cu):
    qkv_weight [3, n_heads, head_dim, embed_dim]."""
    from ...nn import functional as F
    from ...tensor.manipulation import reshape, unstack
    x = _ensure_tensor(x)
    qkv_w = _ensure_tensor(qkv_weight)
    lin_w = _ensure_tensor(linear_weight)
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    _, n_heads, head_dim, _ = qkv_w.shape
    qkv = apply_op(lambda a, w: torch.einsum("bse,thde->bsthd", a, w),
                   x, qkv_w, op_name="qkv_proj")
    if qkv_bias is not None:
        qkv = qkv + _ensure_tensor(qkv_bias)
    q, k, v = unstack(qkv, axis=2)
    out = scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training)
    b, s = out.shape[0], out.shape[1]
    out = reshape(out, [b, s, n_heads * head_dim])
    out = F.linear(out, lin_w, linear_bias)
    out = F.dropout(out, dropout_rate, training=training)
    out = out + residual
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode='upscale_in_train', ring_id=-1, name=None):
    from ...nn import functional as F
    x = _ensure_tensor(x)
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1], ln1_scale, ln1_bias, ln1_epsilon)
    out = F.linear(x, linear1_weight, linear1_bias)
    out = getattr(F, activation)(out)
    out = F.dropout(out, dropout1_rate, training=training)
    out = F.linear(out, linear2_weight, linear2_bias)
    out = F.dropout(out, dropout2_rate, training=training)
    out = out + residual
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """CSR-restricted attention (reference:
    python/paddle/incubate/nn/functional/sparse_attention.py).  Per
    (batch, head) the pattern — offset [B, H, M+1], columns [B, H, nnz]
    — names the keys each query row may attend to: the rows come from
    the offsets by ``searchsorted``, the mask from one scatter, the rest
    is filled with the dtype's ``finfo.min`` before the softmax, and a
    row whose slice is empty outputs zeros.  Dense and masked,
    differentiable through q, k and v; a 0 in either optional mask
    excludes its position too."""
    q = _ensure_tensor(query)
    k = _ensure_tensor(key)
    v = _ensure_tensor(value)
    off = _ensure_tensor(sparse_csr_offset)
    cols = _ensure_tensor(sparse_csr_columns)
    kpm = None if key_padding_mask is None else \
        _ensure_tensor(key_padding_mask)._t.detach()
    am = None if attn_mask is None else \
        _ensure_tensor(attn_mask)._t.detach()

    def _f(qa, ka, va, offa, colsa):
        B, H, M, D = qa.shape
        nnz = colsa.shape[-1]
        scores = torch.einsum("bhmd,bhnd->bhmn", qa, ka) / torch.sqrt(
            torch.tensor(D, dtype=qa.dtype, device=qa.device))
        t = torch.arange(nnz, device=qa.device).expand(B * H, nnz)
        rows = torch.searchsorted(offa.reshape(B * H, M + 1).contiguous(),
                                  t.to(offa.dtype).contiguous(),
                                  right=True) - 1
        rows = rows.reshape(B, H, nnz)
        bi = torch.arange(B, device=qa.device)[:, None, None].expand_as(rows)
        hi = torch.arange(H, device=qa.device)[None, :, None].expand_as(rows)
        mask = torch.zeros((B, H, M, M), dtype=torch.bool, device=qa.device)
        mask[bi, hi, rows, colsa.long()] = True
        neg = torch.tensor(torch.finfo(qa.dtype).min, dtype=qa.dtype,
                           device=qa.device)
        scores = torch.where(mask, scores, neg)
        if kpm is not None:  # [B, M] over the keys
            scores = torch.where(kpm[:, None, None, :] == 0, neg, scores)
        if am is not None:   # [M, M]
            scores = torch.where(am[None, None] == 0, neg, scores)
        attn = torch.softmax(scores, dim=-1)
        any_allowed = mask.any(-1, keepdim=True)
        attn = torch.where(any_allowed, attn,
                           torch.zeros((), dtype=attn.dtype,
                                       device=attn.device))
        return torch.einsum("bhmn,bhnd->bhmd", attn, va)

    return apply_op(_f, q, k, v, off, cols, op_name="sparse_attention")
