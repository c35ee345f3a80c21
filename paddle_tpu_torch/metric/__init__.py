"""Metrics (the port of ``paddle_tpu/metric/__init__.py``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the ``accuracy``
op.  Accuracy's top-k is a stable sort of the scores on their device,
as the reference's sort is stable; the counters run on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import _ensure_tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    input, label = _ensure_tensor(input), _ensure_tensor(label)

    def _f(pred, lab):
        topk_idx = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
        hit = (topk_idx == lab.reshape(-1, 1)).any(-1)
        return hit.float().mean()
    return apply_op(_f, input, label, op_name="accuracy")


_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _torch(x):
    if isinstance(x, Tensor):
        return x._t.detach()
    return x.detach() if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x))


def _np(x):
    t = _torch(x)
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_t = _torch(pred)
        lab_t = _torch(label).to(pred_t.device)
        topk_idx = torch.argsort(-pred_t, dim=-1, stable=True)[..., :self.maxk]
        if lab_t.dim() == pred_t.dim() and lab_t.shape[-1] == 1:
            lab = lab_t
        elif lab_t.dim() == pred_t.dim() - 1:
            lab = lab_t[..., None]
        else:  # one-hot
            lab = torch.argmax(lab_t, -1)[..., None]
        return Tensor._wrap(topk_idx == lab)

    def update(self, correct, *args):
        arr = _np(correct)
        num_samples = arr.shape[0] if arr.ndim else 1
        accs = []
        for k in self.topk:
            c = arr[..., :k].any(axis=-1).sum()
            self.total[self.topk.index(k)] += float(c)
            self.count[self.topk.index(k)] += num_samples
            accs.append(float(c) / num_samples)
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1).astype(np.int32)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fp += int(((pred_cls == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1).astype(np.int32)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fn += int(((pred_cls == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        idx = np.minimum((p * self.num_thresholds).astype(np.int64),
                         self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds, descending
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name
