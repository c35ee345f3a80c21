"""Search and sort ops (the port of ``paddle_tpu/tensor/search.py``).

Ties go as in the reference: sorts are stable whatever ``stable=``
says, ``topk`` takes the lower index first (``lax.top_k``), ``mode``
picks the smallest of the most frequent values and the last index of
it, ``unique`` is sorted with numpy's first-occurrence index.  The
reference runs ``mode`` / ``unique`` / ``histogram`` / ``bincount`` /
``nonzero`` on the host with numpy; here they run on the tensor's
device.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import register, _ensure_tensor

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "nonzero", "searchsorted",
    "kthvalue", "mode", "unique", "unique_consecutive", "bucketize",
    "histogram", "bincount",
]


def _arg(tfn, name):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = _ensure_tensor(x)

        def _f(a):
            if axis is None:
                return tfn(a.reshape(-1))
            return tfn(a, int(axis), keepdim=keepdim)
        return apply_op(_f, x, op_name=name)
    op.__name__ = name
    return op


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.argsort(a, dim=axis, descending=descending,
                                            stable=True),
                    x, op_name="argsort")


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.sort(a, dim=axis, descending=descending,
                                         stable=True).values,
                    x, op_name="sort")


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    x = _ensure_tensor(x)
    if isinstance(k, Tensor):
        k = int(k.item())

    def _f(a):
        vals, idx = torch.sort(a, dim=axis, descending=largest, stable=True)
        return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    return apply_op(_f, x, op_name="topk")


def nonzero(x, as_tuple=False):
    x = _ensure_tensor(x)
    idx = torch.nonzero(x._t)
    if as_tuple:
        return tuple(Tensor._wrap(idx[:, i:i + 1])
                     for i in range(idx.shape[1]))
    return Tensor._wrap(idx)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss, v = _ensure_tensor(sorted_sequence), _ensure_tensor(values)
    return apply_op(lambda s, x: torch.searchsorted(
        s, x.to(s.dtype), out_int32=out_int32, right=right), ss, v,
        op_name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        ax = axis % a.dim()
        vals, idxs = torch.sort(a, dim=ax, stable=True)
        v = vals.select(ax, k - 1)
        i = idxs.select(ax, k - 1)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i
    return apply_op(_f, x, op_name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        ax = axis % a.dim()
        moved = torch.movedim(a, ax, -1)
        flat = moved.reshape(-1, moved.shape[-1])
        counts = (flat[:, :, None] == flat[:, None, :]).sum(-1)
        top = counts == counts.max(-1, keepdim=True).values
        big = torch.full_like(flat, float("inf")) if flat.is_floating_point() \
            else torch.full_like(flat, torch.iinfo(flat.dtype).max)
        best = torch.where(top, flat, big).min(-1, keepdim=True).values
        pos = torch.arange(flat.shape[-1], device=a.device)
        idx = torch.where(flat == best, pos, -1).max(-1).values
        shp = moved.shape[:-1]
        v, i = best.reshape(shp), idx.reshape(shp)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i
    with torch.no_grad():
        return apply_op(_f, x, op_name="mode")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = _ensure_tensor(x)
    a = x._t.detach()
    src = a.reshape(-1) if axis is None else a
    u, inv, cnt = torch.unique(src, sorted=True, return_inverse=True,
                               return_counts=True, dim=axis)
    outs = [u]
    if return_index:
        n = src.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=a.device)
        first = torch.full((u.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=a.device)
        outs.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(cnt)
    if len(outs) == 1:
        return Tensor._wrap(u)
    return tuple(Tensor._wrap(o) for o in outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = _ensure_tensor(x)
    a = x._t.detach()
    out, inv, cnt = torch.unique_consecutive(
        a.reshape(-1) if axis is None else a, return_inverse=True,
        return_counts=True, dim=axis)
    rets = [Tensor._wrap(out)]
    if return_inverse:
        rets.append(Tensor._wrap(inv))
    if return_counts:
        rets.append(Tensor._wrap(cnt))
    return rets[0] if len(rets) == 1 else tuple(rets)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    input = _ensure_tensor(input)
    a = input._t.detach()
    a = a if a.dtype == torch.float64 else a.float()
    if min == 0 and max == 0:
        lo, hi = a.min().item(), a.max().item()
    else:
        lo, hi = min, max
    return Tensor._wrap(torch.histc(a, bins=bins, min=lo, max=hi).long())


def bincount(x, weights=None, minlength=0, name=None):
    x = _ensure_tensor(x)
    w = _ensure_tensor(weights)._t.detach() if weights is not None else None
    out = torch.bincount(x._t.detach(), weights=w, minlength=minlength)
    return Tensor._wrap(out.to(w.dtype) if w is not None else out)


for _n in __all__:
    register(_n, globals()[_n])
