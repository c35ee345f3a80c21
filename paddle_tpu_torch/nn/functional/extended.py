"""Sequence, beam-search and margin-loss functionals (the port of
``paddle_tpu/nn/functional/extended.py``): ``sequence_mask``,
``gather_tree``, ``class_center_sample``, ``margin_cross_entropy`` and
``edit_distance``.

``class_center_sample`` and ``edit_distance`` run on the host in
numpy, as the reference's do (their sizes depend on the data); their
results land on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ...core.dtype import convert_dtype
from ...core.tensor import Tensor, apply_op
from ...ops.registry import register, _ensure_tensor

__all__ = ["sequence_mask", "gather_tree", "class_center_sample",
           "margin_cross_entropy"]


def _host(t):
    return _ensure_tensor(t).numpy()


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths → 0/1 mask [..., maxlen]."""
    x = _ensure_tensor(x)
    if maxlen is None:
        maxlen = int(x._t.max())
    dt = convert_dtype(dtype)

    def _f(a):
        return (torch.arange(maxlen, device=a.device) < a[..., None]).to(dt)
    return apply_op(_f, x, op_name="sequence_mask")


def gather_tree(ids, parents):
    """Beam-search backtrace: [T, B, beam] ids and parent indices → the
    full beams, walking time backwards from the last step."""
    ids, parents = _ensure_tensor(ids), _ensure_tensor(parents)

    def _f(ids_a, par_a):
        T, B, K = ids_a.shape
        beam = torch.arange(K, device=ids_a.device).expand(B, K)
        outs = [None] * T
        for t in reversed(range(T)):
            outs[t] = torch.gather(ids_a[t], 1, beam)
            beam = torch.gather(par_a[t], 1, beam).long()
        return torch.stack(outs)
    return apply_op(_f, ids, parents, op_name="gather_tree")


def class_center_sample(label, num_classes, num_samples, group=None):
    """Sample class centers (PartialFC): every positive class, padded
    with negatives drawn from numpy's global RNG to ``num_samples``;
    returns (remapped_label, sampled_class_center)."""
    label = _ensure_tensor(label)
    lab = label.numpy()
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.choice(rest, size=num_samples - len(pos),
                                 replace=False)
        sampled = np.concatenate([pos, np.sort(extra)])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = label._t.device
    return (Tensor._wrap(torch.from_numpy(remap[lab]).to(dev)),
            Tensor._wrap(torch.from_numpy(sampled.astype(np.int64)).to(dev)))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax CE: the target's cos θ becomes
    cos(m1·θ + m2) − m3, and every logit is scaled by ``scale``."""
    logits, label = _ensure_tensor(logits), _ensure_tensor(label)

    def _f(lg, lb):
        lb = lb.reshape(-1).long()
        one_hot = tF.one_hot(lb, lg.shape[-1]).to(lg.dtype)
        # an epsilon keeps arccos' infinite slope off the clip's bounds
        eps = 1e-6
        cos = torch.clamp(lg, -1.0 + eps, 1.0 - eps)
        target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
        adjusted = torch.where(one_hot > 0, target, cos) * scale
        logp = torch.log_softmax(adjusted, -1)
        loss = -torch.sum(one_hot * logp, -1)
        if reduction == "mean":
            loss = loss.mean()
        elif reduction == "sum":
            loss = loss.sum()
        if return_softmax:
            return loss, torch.exp(logp)
        return loss
    return apply_op(_f, logits, label, op_name="margin_cross_entropy")


for _n in __all__:
    register(_n, globals()[_n])


def edit_distance(input, label, normalized=True, ignored_tokens=None,  # noqa: A002
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance between batches of token sequences, by the
    host-side dynamic program.  Returns (distances [B, 1] float32,
    sequence_num [1])."""
    a, b = _host(input), _host(label)
    il = None if input_length is None else _host(input_length).reshape(-1)
    ll = None if label_length is None else _host(label_length).reshape(-1)
    ignored = set(ignored_tokens or [])
    B = a.shape[0]
    out = np.zeros((B, 1), np.float32)
    for n in range(B):
        s = a[n][:il[n]] if il is not None else a[n]
        t = b[n][:ll[n]] if ll is not None else b[n]
        s = [int(v) for v in s if int(v) not in ignored]
        t = [int(v) for v in t if int(v) not in ignored]
        dp = np.arange(len(t) + 1, dtype=np.float32)
        for i in range(1, len(s) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, len(t) + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (s[i - 1] != t[j - 1]))
        d = dp[len(t)]
        if normalized:
            d = d / max(len(t), 1)
        out[n, 0] = d
    dev = _ensure_tensor(input)._t.device
    return (Tensor._wrap(torch.from_numpy(out).to(dev)),
            Tensor._wrap(torch.tensor([B], dtype=torch.int64, device=dev)))


register("edit_distance", edit_distance)
__all__ += ["edit_distance"]
