"""Loss functionals (the port of ``paddle_tpu/nn/functional/loss.py``).

Each loss is the reference's composition in torch ops, not torch's own
loss function, whose edge cases differ: ``cross_entropy``'s mean over
nothing but ignored labels is 0 (the denominator is ``max(Σ valid,
1)``), its weighted mean divides by the valid labels' ``Σ w``, a label
of shape [N, 1] is squeezed, labels of any dtype are cast to integers,
and ``log_softmax`` runs in the logits' dtype (bf16 on the Llama path).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Tensor, apply_op
from ...ops.registry import register, _ensure_tensor

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "cosine_embedding_loss",
    "hinge_embedding_loss", "triplet_margin_loss", "ctc_loss", "square_error_cost",
    "sigmoid_focal_loss", "log_loss", "npair_loss", "softmax_cross_entropy_with_logits",
    "multi_label_soft_margin_loss", "soft_margin_loss", "poisson_nll_loss",
    "rnnt_loss", "hsigmoid_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _labels(y, like):
    """bool labels as 0/1 in ``like``'s dtype (jnp promotes them)."""
    return y.to(like.dtype) if y.dtype == torch.bool else y


def _softplus(a):
    return torch.logaddexp(a, _zero(a))


def _one_hot(lab, n, axis, dtype):
    oh = (lab[..., None] == torch.arange(n, device=lab.device)).to(dtype)
    return torch.movedim(oh, -1, axis)


def cross_entropy_raw(logits, lab, weight=None, ignore_index=-100,
                      reduction="mean", soft_label=False, axis=-1,
                      use_softmax=True, label_smoothing=0.0):
    """``cross_entropy`` on torch tensors."""
    ax = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(logits, ax)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-15))
    n_class = logits.shape[ax]
    if soft_label:
        soft = lab
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        per = -torch.sum(soft * logp, ax)
        if weight is not None:
            cw = torch.sum(soft * weight.reshape(
                [1] * ax + [-1] + [1] * (logits.dim() - ax - 1)), ax)
            per = per * cw
        return _reduce(per, reduction)
    lab_ = lab
    if lab_.dim() == logits.dim() and lab_.shape[ax] == 1:
        lab_ = torch.squeeze(lab_, ax)
    lab_int = lab_.long()
    valid = lab_int != ignore_index
    safe_lab = torch.where(valid, lab_int, torch.zeros_like(lab_int))
    if label_smoothing > 0:
        onehot = _one_hot(safe_lab, n_class, ax, logp.dtype)
        soft = onehot * (1 - label_smoothing) + label_smoothing / n_class
        per = -torch.sum(soft * logp, ax)
    else:
        per = -torch.gather(logp, ax, safe_lab.unsqueeze(ax)).squeeze(ax)
    per = torch.where(valid, per, _zero(per))
    if weight is not None:
        cw = weight[safe_lab]
        cw = torch.where(valid, cw, _zero(cw))
        per = per * cw
        if reduction == "mean":
            return torch.sum(per) / torch.clamp(torch.sum(cw), min=1e-12)
    if reduction == "mean":
        denom = torch.clamp(torch.sum(valid.to(per.dtype)), min=1.0)
        return torch.sum(per) / denom
    return _reduce(per, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    input = _ensure_tensor(input)
    label = _ensure_tensor(label)
    args = [input, label]
    if weight is not None:
        args.append(_ensure_tensor(weight))

    def _f(logits, lab, *w):
        return cross_entropy_raw(logits, lab, w[0] if w else None,
                                 ignore_index, reduction, soft_label, axis,
                                 use_softmax, label_smoothing)
    return apply_op(_f, *args, op_name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    from .activation import softmax as softmax_fn
    from ...tensor.manipulation import unsqueeze
    if not soft_label:
        loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax_fn(logits, axis=axis)
    return loss


def softmax_cross_entropy_with_logits(logits, labels, axis=-1):
    return cross_entropy(logits, labels, soft_label=True, axis=axis,
                         reduction="none")


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    input = _ensure_tensor(input)
    label = _ensure_tensor(label)
    args = [input, label]
    if weight is not None:
        args.append(_ensure_tensor(weight))

    def _f(p, y, *w):
        y = _labels(y, p)
        p = torch.clamp(p, 1e-12, 1 - 1e-12)
        per = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if w:
            per = per * w[0]
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit = _ensure_tensor(logit)
    label = _ensure_tensor(label)
    args = [logit, label]
    has_w = weight is not None
    has_pw = pos_weight is not None
    if has_w:
        args.append(_ensure_tensor(weight))
    if has_pw:
        args.append(_ensure_tensor(pos_weight))

    def _f(z, y, *rest):
        i = 0
        w = rest[i] if has_w else None
        i += 1 if has_w else 0
        pw = rest[i] if has_pw else None
        max_val = torch.clamp(-z, min=0)
        if pw is not None:
            log_weight = (pw - 1) * y + 1
            per = (1 - y) * z + log_weight * (
                torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
                + max_val)
        else:
            per = (1 - y) * z + max_val + torch.log(
                torch.exp(-max_val) + torch.exp(-z - max_val))
        if w is not None:
            per = per * w
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="bce_with_logits")


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    return apply_op(lambda a, b: _reduce((a - b) ** 2, reduction),
                    input, label, op_name="mse_loss")


def square_error_cost(input, label):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    return apply_op(lambda a, b: (a - b) ** 2, input, label,
                    op_name="square_error_cost")


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    return apply_op(lambda a, b: _reduce(torch.abs(a - b), reduction),
                    input, label, op_name="l1_loss")


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    input = _ensure_tensor(input)
    label = _ensure_tensor(label)
    args = [input, label]
    if weight is not None:
        args.append(_ensure_tensor(weight))

    def _f(logp, y, *w):
        y_int = y.long()
        valid = y_int != ignore_index
        safe = torch.where(valid, y_int, torch.zeros_like(y_int))
        per = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
        cw = w[0][safe] if w else torch.ones_like(per)
        cw = torch.where(valid, cw, _zero(cw))
        per = per * cw
        if reduction == "mean":
            return torch.sum(per) / torch.clamp(torch.sum(cw), min=1e-12)
        per = torch.where(valid, per, _zero(per))
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="nll_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)

    def _f(a, b):
        d = a - b
        abs_d = torch.abs(d)
        per = torch.where(abs_d < delta, 0.5 * d * d / delta,
                          abs_d - 0.5 * delta)
        return _reduce(per, reduction)
    return apply_op(_f, input, label, op_name="smooth_l1_loss")


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)

    def _f(logp, y):
        per = y * (torch.log(torch.clamp(y, min=1e-12)) - logp)
        return _reduce(per, reduction)
    return apply_op(_f, input, label, op_name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",  # noqa: A002
                        name=None):
    input, other = _ensure_tensor(input), _ensure_tensor(other)
    label = _ensure_tensor(label)
    return apply_op(
        lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin, min=0),
                                reduction),
        input, other, label, op_name="margin_ranking_loss")


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    input1, input2 = _ensure_tensor(input1), _ensure_tensor(input2)
    label = _ensure_tensor(label)

    def _f(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp(_norm(a) * _norm(b),
                                                 min=1e-12)
        per = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0))
        return _reduce(per, reduction)
    return apply_op(_f, input1, input2, label,
                    op_name="cosine_embedding_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    input, label = _ensure_tensor(input), _ensure_tensor(label)

    def _f(a, y):
        per = torch.where(y == 1, a, torch.clamp(margin - a, min=0))
        return _reduce(per, reduction)
    return apply_op(_f, input, label, op_name="hinge_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    input = _ensure_tensor(input)
    positive, negative = _ensure_tensor(positive), _ensure_tensor(negative)

    def _f(a, pos, neg):
        def dist(u, v):
            return torch.sum(torch.abs(u - v + epsilon) ** p, -1) ** (1.0 / p)
        d_pos = dist(a, pos)
        d_neg = dist(a, neg)
        if swap:
            d_neg = torch.minimum(d_neg, dist(pos, neg))
        per = torch.clamp(d_pos - d_neg + margin, min=0)
        return _reduce(per, reduction)
    return apply_op(_f, input, positive, negative,
                    op_name="triplet_margin_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space, one step per frame."""
    log_probs = _ensure_tensor(log_probs)   # [T, B, C] (paddle layout)
    labels = _ensure_tensor(labels)         # [B, S]
    input_lengths = _ensure_tensor(input_lengths)
    label_lengths = _ensure_tensor(label_lengths)

    def _f(lp, lab, in_len, lab_len):
        T, B, C = lp.shape
        S = lab.shape[1]
        dev = lp.device
        ext = torch.full((B, 2 * S + 1), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lab.long()
        L = 2 * S + 1
        neg_inf = torch.full((), -1e30, dtype=lp.dtype, device=dev)

        first_lab = torch.gather(lp[0], 1, ext[:, 1:2])[:, 0]
        alpha0 = torch.cat([lp[0, :, blank][:, None], first_lab[:, None],
                            neg_inf.expand(B, L - 2)], 1)
        same_as_prevprev = torch.cat(
            [torch.ones((B, 2), dtype=torch.bool, device=dev),
             ext[:, 2:] == ext[:, :-2]], 1)
        alphas = [alpha0]
        alpha = alpha0
        for t in range(1, T):
            a_shift1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], 1)
            a_shift2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], 1)
            a_shift2 = torch.where(same_as_prevprev, neg_inf, a_shift2)
            merged = torch.logaddexp(torch.logaddexp(alpha, a_shift1),
                                     a_shift2)
            alpha = merged + torch.gather(lp[t], 1, ext)
            alphas.append(alpha)
        alphas = torch.stack(alphas, 0)                       # [T, B, L]

        t_idx = in_len.long() - 1
        final = alphas[t_idx, torch.arange(B, device=dev)]   # [B, L]
        l_end = 2 * lab_len.long()
        p_blank = torch.gather(final, 1, l_end[:, None])[:, 0]
        p_label = torch.gather(final, 1,
                               torch.clamp(l_end - 1, min=0)[:, None])[:, 0]
        loss = -torch.logaddexp(p_blank, p_label)
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(lab_len.to(loss.dtype),
                                                 min=1))
        return _reduce(loss, reduction)
    return apply_op(_f, log_probs, labels, input_lengths, label_lengths,
                    op_name="ctc_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label = _ensure_tensor(logit), _ensure_tensor(label)
    args = [logit, label]
    if normalizer is not None:
        args.append(_ensure_tensor(normalizer))

    def _f(z, y, *nz):
        y = _labels(y, z)
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(
            torch.exp(-torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        per = a_t * ((1 - p_t) ** gamma) * ce
        if nz:
            per = per / nz[0]
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="sigmoid_focal_loss")


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    return apply_op(
        lambda p, y: -y * torch.log(p + epsilon)
        - (1 - y) * torch.log(1 - p + epsilon),
        input, label, op_name="log_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    anchor, positive = _ensure_tensor(anchor), _ensure_tensor(positive)
    labels = _ensure_tensor(labels)

    def _f(a, p, y):
        reg = l2_reg * (torch.mean(torch.sum(a * a, 1))
                        + torch.mean(torch.sum(p * p, 1))) * 0.25
        sim = a @ p.T
        y = y.reshape(-1, 1)
        same = (y == y.T).to(sim.dtype)
        same = same / torch.sum(same, 1, keepdim=True)
        logp = torch.log_softmax(sim, 1)
        ce = -torch.mean(torch.sum(same * logp, 1))
        return ce + reg
    return apply_op(_f, anchor, positive, labels, op_name="npair_loss")


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    args = [input, label]
    if weight is not None:
        args.append(_ensure_tensor(weight))

    def _f(z, y, *w):
        y = _labels(y, z)
        per = -(y * -_softplus(-z) + (1 - y) * -_softplus(z))
        if w:
            per = per * w[0]
        per = torch.mean(per, -1)
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="multi_label_soft_margin_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)
    return apply_op(
        lambda z, y: _reduce(torch.log1p(torch.exp(-y * z)), reduction),
        input, label, op_name="soft_margin_loss")


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    input, label = _ensure_tensor(input), _ensure_tensor(label)

    def _f(x, y):
        if log_input:
            per = torch.exp(x) - y * x
        else:
            per = x - y * torch.log(x + epsilon)
        if full:
            stirling = y * torch.log(y + epsilon) - y \
                + 0.5 * torch.log(2 * math.pi * (y + epsilon))
            per = per + torch.where(y > 1, stirling, _zero(stirling))
        return _reduce(per, reduction)
    return apply_op(_f, input, label, op_name="poisson_nll_loss")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,  # noqa: A002
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN transducer loss (Graves 2012).  input: [B, T, U+1, V] logits;
    label: [B, U] int; lengths per sample.  The alpha recursion steps
    over time; each row's label-axis recurrence is a log-cumsum-exp."""
    input = _ensure_tensor(input)  # noqa: A001
    label = _ensure_tensor(label)
    input_lengths = _ensure_tensor(input_lengths)
    label_lengths = _ensure_tensor(label_lengths)

    def _f(logits, labels, t_lens, u_lens):
        B, T, U1, V = logits.shape
        U = U1 - 1
        dev = logits.device
        lp = torch.log_softmax(logits.float(), -1)
        blank_lp = lp[..., blank]                          # [B, T, U+1]
        lab_lp = torch.gather(
            lp[:, :, :U, :], 3,
            labels[:, None, :, None].long().expand(B, T, U, 1))[..., 0]
        if fastemit_lambda:
            # FastEmit: the value is unchanged; the gradients through
            # label emissions are scaled by (1 + lambda)
            lam = float(fastemit_lambda)
            lab_lp = lab_lp * (1.0 + lam) - (lab_lp * lam).detach()
        zeros = torch.zeros((B, 1), dtype=torch.float32, device=dev)
        alpha = torch.cat([zeros, torch.cumsum(lab_lp[:, 0, :], -1)], -1)
        rows = [alpha]
        for t in range(1, T):
            c = torch.cat([zeros, torch.cumsum(lab_lp[:, t, :], -1)], -1)
            g = alpha + blank_lp[:, t - 1, :] - c
            alpha = c + torch.logcumsumexp(g, -1)
            rows.append(alpha)
        all_rows = torch.stack(rows, 1)                    # [B, T, U+1]
        tb = torch.clamp(t_lens.long() - 1, 0, T - 1)
        ub = torch.clamp(u_lens.long(), 0, U)
        bidx = torch.arange(B, device=dev)
        per = -(all_rows[bidx, tb, ub] + blank_lp[bidx, tb, ub])
        if reduction == "mean":
            return torch.mean(per)
        if reduction == "sum":
            return torch.sum(per)
        return per

    return apply_op(_f, input, label, input_lengths, label_lengths,
                    op_name="rnnt_loss")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss: binary decisions along each class's
    path through a code tree.  Custom trees pass path_table/path_code;
    the default is the complete binary tree over num_classes leaves
    (heap numbering), whose paths are derived from the labels on the
    host, as in the reference."""
    input = _ensure_tensor(input)  # noqa: A001
    label = _ensure_tensor(label)
    weight = _ensure_tensor(weight)
    if path_table is None or path_code is None:
        lab = label.numpy().reshape(-1)
        depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
        tables = np.full((len(lab), depth), -1, np.int64)
        codes = np.zeros((len(lab), depth), np.float32)
        for n, c in enumerate(lab):
            node = int(c) + num_classes
            path = []
            while node > 1:
                path.append((node // 2 - 1, node & 1))
                node //= 2
            for d, (idx, bit) in enumerate(reversed(path)):
                tables[n, d] = idx
                codes[n, d] = bit
        dev = input._t.device
        path_table = Tensor._wrap(torch.from_numpy(tables).to(dev))
        path_code = Tensor._wrap(torch.from_numpy(codes).to(dev))
    else:
        path_table = _ensure_tensor(path_table)
        path_code = _ensure_tensor(path_code)
    args = [input, weight, path_table, path_code]
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(x, w, tbl, code, *b):
        mask = (tbl >= 0).float()                           # [N, L]
        safe = torch.clamp(tbl.long(), 0, w.shape[0] - 1)
        wrows = w[safe]                                     # [N, L, D]
        z = torch.einsum("nld,nd->nl", wrows.float(), x.float())
        if b:
            # bias is documented as [num_classes-1, 1] (1-D also taken)
            z = z + b[0].reshape(-1)[safe]
        # BCE with target = code: softplus(z) - code * z
        per = (_softplus(z) - code * z) * mask
        return torch.sum(per, -1, keepdim=True)

    return apply_op(_f, *args, op_name="hsigmoid_loss")


for _n in __all__:
    register(_n, globals()[_n])


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """1 - 2|X∩Y|/(|X|+|Y|) over the class probabilities: input
    [N, ..., C] probabilities, label [N, ..., 1] int."""
    input = _ensure_tensor(input)  # noqa: A001
    label = _ensure_tensor(label)

    def _f(p, y):
        oh = _one_hot(torch.squeeze(y, -1).long(), p.shape[-1], -1, p.dtype)
        reduce_dims = tuple(range(1, p.dim()))
        inter = torch.sum(p * oh, reduce_dims)
        union = torch.sum(p, reduce_dims) + torch.sum(oh, reduce_dims)
        dice = (2.0 * inter + epsilon) / (union + epsilon)
        return torch.mean(1.0 - dice)
    return apply_op(_f, input, label, op_name="dice_loss")


def multi_margin_loss(input, label, p=1, margin=1.0,  # noqa: A002
                      weight=None, reduction="mean", name=None):
    """mean_j max(0, margin - x[y] + x[j])^p over j != y, per sample."""
    input = _ensure_tensor(input)  # noqa: A001
    label = _ensure_tensor(label)
    args = [input, label] + ([_ensure_tensor(weight)]
                             if weight is not None else [])

    def _f(x, y, *w):
        C = x.shape[-1]
        y = y.long()
        correct = torch.gather(x, -1, y[:, None])
        per = torch.clamp(margin - correct + x, min=0.0) ** p
        if w:
            per = per * w[0][y][:, None]
        mask = 1.0 - _one_hot(y, C, -1, x.dtype)
        per = torch.sum(per * mask, -1) / C
        return _reduce(per, reduction)
    return apply_op(_f, *args, op_name="multi_margin_loss")


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """Triplet loss with a caller-supplied distance (default: pairwise
    L2)."""
    input = _ensure_tensor(input)  # noqa: A001
    positive = _ensure_tensor(positive)
    negative = _ensure_tensor(negative)
    if distance_function is None:
        def distance_function(u, v):
            diff = u - v
            diff = diff._t if isinstance(diff, Tensor) else diff
            return torch.sqrt(torch.clamp(torch.sum(diff * diff, -1),
                                          min=1e-12))

    def _f(a, pos, neg):
        def dist(u, v):
            d = distance_function(u, v)
            return d._t if isinstance(d, Tensor) else d
        d_pos = dist(a, pos)
        d_neg = dist(a, neg)
        if swap:
            d_neg = torch.minimum(d_neg, dist(pos, neg))
        per = torch.clamp(d_pos - d_neg + margin, min=0)
        return _reduce(per, reduction)
    return apply_op(_f, input, positive, negative,
                    op_name="triplet_margin_with_distance_loss")


__all__ += ["dice_loss", "multi_margin_loss",
            "triplet_margin_with_distance_loss"]
for _n in ("dice_loss", "multi_margin_loss",
           "triplet_margin_with_distance_loss"):
    register(_n, globals()[_n])
