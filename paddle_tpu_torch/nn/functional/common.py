"""Common functionals: linear, dropout, embedding, interpolate,
attention (the port of ``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor, apply_op
from ...ops.registry import register, _ensure_tensor
from ...framework.random import generator_for

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "label_smooth", "cosine_similarity",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "interpolate",
    "upsample", "bilinear", "unfold", "fold", "scaled_dot_product_attention",
    "pairwise_distance", "zeropad2d",
]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with paddle's [in, out] weight layout."""
    x, weight = _ensure_tensor(x), _ensure_tensor(weight)
    if bias is not None:
        return apply_op(lambda a, w, b: torch.matmul(a, w) + b, x, weight,
                        _ensure_tensor(bias), op_name="linear")
    return apply_op(torch.matmul, x, weight, op_name="linear")


def _keep_mask(shape, p, device, generator=None):
    """``bernoulli(1 - p)``: a uniform draw below 1 - p."""
    gen = generator if generator is not None else generator_for(device)
    return torch.rand(shape, generator=gen, device=device) < (1 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, rng_key=None):
    """``rng_key``: a ``torch.Generator`` on x's device to draw the mask
    from (default: the global one)."""
    x = _ensure_tensor(x)
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            return apply_op(lambda a: a * (1 - p), x, op_name="dropout_infer")
        return x
    a0 = x._t
    shape = list(a0.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(a0.shape)]
    keep = _keep_mask(shape, p, a0.device, rng_key)

    def _f(a):
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1 - p), zero).to(a.dtype)
        return torch.where(keep, a, zero).to(a.dtype)
    return apply_op(_f, x, op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axes = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axes, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axes = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axes, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    x = _ensure_tensor(x)
    if not training or p == 0:
        return x
    keep = _keep_mask(x._t.shape, p, x._t.device)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def _f(a):
        q = 1 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        fill = torch.full((), alpha_p, dtype=a.dtype, device=a.device)
        return (a_coef * torch.where(keep, a, fill) + b_coef).to(a.dtype)
    return apply_op(_f, x, op_name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    x, weight = _ensure_tensor(x), _ensure_tensor(weight)

    def _f(ids, w):
        out = w[ids.long()]
        if padding_idx is not None:
            mask = (ids == padding_idx)[..., None]
            out = torch.where(mask, torch.zeros((), dtype=out.dtype,
                                                device=out.device), out)
        return out
    return apply_op(_f, x, weight, op_name="embedding")


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows (an out-of-range label gives zeros)."""
    x = _ensure_tensor(x)
    return apply_op(
        lambda a: (a.long()[..., None] == torch.arange(
            num_classes, device=a.device)).to(torch.float32),
        x, op_name="one_hot")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label = _ensure_tensor(label)
    args = [label]
    if prior_dist is not None:
        args.append(_ensure_tensor(prior_dist))

    def _f(y, *pd):
        k = y.shape[-1]
        if pd:
            return (1 - epsilon) * y + epsilon * pd[0]
        return (1 - epsilon) * y + epsilon / k
    return apply_op(_f, *args, op_name="label_smooth")


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = _ensure_tensor(x1), _ensure_tensor(x2)

    def _f(a, b):
        dot = torch.sum(a * b, axis)
        na = torch.linalg.vector_norm(a, dim=axis)
        nb = torch.linalg.vector_norm(b, dim=axis)
        return dot / torch.clamp(na * nb, min=eps)
    return apply_op(_f, x1, x2, op_name="cosine_similarity")


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(
        lambda a, b: torch.sum(torch.abs(a - b + epsilon) ** p, -1,
                               keepdim=keepdim) ** (1.0 / p),
        x, y, op_name="pairwise_distance")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    x = _ensure_tensor(x)
    r = upscale_factor

    def _f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c // (r * r), r, r, h, w)
            out = out.permute(0, 1, 4, 2, 5, 3)
            return out.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        out = a.reshape(n, h, w, r, r, c // (r * r))
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h * r, w * r, c // (r * r))
    return apply_op(_f, x, op_name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    x = _ensure_tensor(x)
    r = downscale_factor

    def _f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c, h // r, r, w // r, r)
            out = out.permute(0, 1, 3, 5, 2, 4)
            return out.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        out = a.reshape(n, h // r, r, w // r, r, c)
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h // r, w // r, c * r * r)
    return apply_op(_f, x, op_name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, groups, c // groups, h, w)
            out = out.permute(0, 2, 1, 3, 4)
            return out.reshape(n, c, h, w)
        n, h, w, c = a.shape
        out = a.reshape(n, h, w, groups, c // groups)
        out = out.permute(0, 1, 2, 4, 3)
        return out.reshape(n, h, w, c)
    return apply_op(_f, x, op_name="channel_shuffle")


def _linear_kernel(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic_kernel(x):
    x = torch.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(out), out)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image.resize``'s [n_in, n_out] weight matrix for one axis
    (half-pixel centres, antialiased when shrinking)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = torch.sum(w, 0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * float(
        torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes: ``nearest`` takes floor(dst * in / out);
    the linear and cubic modes are ``jax.image.resize``'s (half-pixel
    centres whatever ``align_corners`` says, antialiased when
    shrinking, Keys' cubic with a = -0.5)."""
    x = _ensure_tensor(x)
    channels_last = data_format.endswith("C") and len(data_format) > 3 \
        or data_format in ("NHWC", "NDHWC", "NLC")
    nd = x.ndim - 2
    spatial = x.shape[1:1 + nd] if channels_last else x.shape[2:2 + nd]
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        out_sizes = [int(s.item()) if isinstance(s, Tensor) else int(s)
                     for s in (size if isinstance(size, (list, tuple))
                               else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out_sizes = [int(s * f) for s, f in zip(spatial, sf)]

    kind = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic",
            "area": "linear"}[mode]

    def _f(a):
        first = 1 if channels_last else 2
        out = a
        for i, (n_in, n_out) in enumerate(zip(spatial, out_sizes)):
            ax = first + i
            if kind == "nearest":
                idx = torch.floor(torch.arange(n_out, device=a.device)
                                  * (n_in / n_out)).long()
                out = torch.index_select(out, ax, idx.clamp(0, n_in - 1))
                continue
            if n_in == n_out:
                continue
            kern = _linear_kernel if kind == "linear" else _keys_cubic_kernel
            w = _resize_weights(n_in, n_out, kern, a.device).to(out.dtype)
            out = torch.movedim(torch.movedim(out, ax, -1) @ w, -1, ax)
        return out
    return apply_op(_f, x, op_name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    x1, x2 = _ensure_tensor(x1), _ensure_tensor(x2)
    weight = _ensure_tensor(weight)
    args = [x1, x2, weight]
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(a, b, w, *bi):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        if bi:
            out = out + bi[0]
        return out
    return apply_op(_f, *args, op_name="bilinear")


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> [N, C*kh*kw, L] (paddings [top, left, bottom,
    right] or [h, w])."""
    x = _ensure_tensor(x)
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]

    def _f(a):
        a_p = TF.pad(a, [pd[1], pd[3], pd[0], pd[2]])
        return TF.unfold(a_p, ks, dilation=dl, stride=st)
    return apply_op(_f, x, op_name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    x = _ensure_tensor(x)
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, pd, dl = _pair(strides), _pair(paddings), _pair(dilations)

    def _f(a):
        n, ckk, L = a.shape
        c = ckk // (ks[0] * ks[1])
        oh = (os_[0] + 2 * pd[0] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
        ow = (os_[1] + 2 * pd[1] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
        a_r = a.reshape(n, c, ks[0], ks[1], oh, ow)
        out = torch.zeros((n, c, os_[0] + 2 * pd[0], os_[1] + 2 * pd[1]),
                          dtype=a.dtype, device=a.device)
        for i in range(ks[0]):
            for j in range(ks[1]):
                hi = i * dl[0]
                wj = j * dl[1]
                out[:, :, hi:hi + oh * st[0]:st[0],
                    wj:wj + ow * st[1]:st[1]] += a_r[:, :, i, j]
        return out[:, :, pd[0]:out.shape[2] - pd[0],
                   pd[1]:out.shape[3] - pd[1]]
    return apply_op(_f, x, op_name="fold")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    from ...tensor.manipulation import pad as pad_fn
    return pad_fn(x, padding, mode="constant", value=0.0,
                  data_format=data_format)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over [batch, seq, heads, head_dim], the reference's
    composition: scaled logits, the causal and given masks, a float32
    softmax cast back, dropout, the weighted sum."""
    query, key, value = (_ensure_tensor(query), _ensure_tensor(key),
                         _ensure_tensor(value))
    args = [query, key, value]
    if attn_mask is not None:
        args.append(_ensure_tensor(attn_mask))
    keep = None
    if dropout_p > 0 and training:
        B, S, H, _ = query.shape
        keep = _keep_mask([B, H, S, key.shape[1]], dropout_p,
                          query._t.device)

    def _f(q, k, v, *m):
        scale = 1.0 / math.sqrt(q.shape[-1])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) * scale
        ninf = torch.full((), float("-inf"), dtype=logits.dtype,
                          device=logits.device)
        if is_causal:
            s, t = logits.shape[-2], logits.shape[-1]
            causal = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                           device=q.device))
            logits = torch.where(causal, logits, ninf)
        if m:
            mask = m[0]
            if mask.dtype == torch.bool:
                logits = torch.where(mask, logits, ninf)
            else:
                logits = logits + mask
        probs = torch.softmax(logits.float(), -1).to(q.dtype)
        if keep is not None:
            probs = torch.where(keep, probs / (1 - dropout_p),
                                torch.zeros((), dtype=probs.dtype,
                                            device=probs.device))
        out = torch.einsum("bhst,bhtd->bhsd", probs, vt)
        return out.transpose(1, 2)
    return apply_op(_f, *args, op_name="scaled_dot_product_attention")


for _n in __all__:
    register(_n, globals()[_n])
