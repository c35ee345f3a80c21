"""Graph message passing (the port of ``paddle_tpu/geometric``): the
segment reductions, ``send_u_recv`` / ``send_ue_recv`` / ``send_uv``,
neighbor sampling and reindexing.

The reductions are scatters over the segment ids: ``index_add`` for
sums and ``scatter_reduce`` for max / min, whose gradient, like
``jax.ops.segment_max``'s, splits a tie evenly.  An empty segment holds
the reduction's identity: 0 for sums and means, -inf / +inf for max /
min, as the reference's.  Sampling and reindexing run on the host in
numpy, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import register, _ensure_tensor

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min",
           "sample_neighbors", "reindex_graph", "reindex_heter_graph"]


def _seg_sum(d, s, n):
    return torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                       device=d.device).index_add(0, s, d)


def _seg_extremum(reduce, fill):
    def red(d, s, n):
        out = torch.full((n,) + tuple(d.shape[1:]), fill, dtype=d.dtype,
                         device=d.device)
        idx = s.reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
        return out.scatter_reduce(0, idx, d, reduce, include_self=False)
    return red


def _seg_mean(d, s, n):
    return _seg_sum(d, s, n) / torch.clamp(
        _seg_sum(torch.ones_like(d), s, n), min=1)


_REDUCERS = {
    "sum": _seg_sum,
    "mean": _seg_mean,
    "max": _seg_extremum("amax", -float("inf")),
    "min": _seg_extremum("amin", float("inf")),
}


def _segment(name, combiner):
    def op(data, segment_ids, name=None):
        data, segment_ids = _ensure_tensor(data), _ensure_tensor(segment_ids)
        num = int(segment_ids._t.max()) + 1 if segment_ids.size else 0
        return apply_op(lambda d, s: combiner(d, s.long(), num), data,
                        segment_ids, op_name=op.__name__)
    op.__name__ = name
    register(name, op)
    return op


segment_sum = _segment("segment_sum", _REDUCERS["sum"])
segment_mean = _segment("segment_mean", _REDUCERS["mean"])
segment_max = _segment("segment_max", _REDUCERS["max"])
segment_min = _segment("segment_min", _REDUCERS["min"])


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    x = _ensure_tensor(x)
    n_out = out_size or x.shape[0]

    def _f(xa, si, di):
        return _REDUCERS[reduce_op](xa[si.long()], di.long(), n_out)
    return apply_op(_f, x, _ensure_tensor(src_index),
                    _ensure_tensor(dst_index), op_name="send_u_recv")


_MESSAGE = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    n_out = out_size or x.shape[0]

    def _f(xa, ya, si, di):
        msgs = _MESSAGE[message_op](xa[si.long()], ya)
        return _REDUCERS[reduce_op](msgs, di.long(), n_out)
    return apply_op(_f, x, y, _ensure_tensor(src_index),
                    _ensure_tensor(dst_index), op_name="send_ue_recv")


def send_uv(x, y, src_index, dst_index, compute_type="add", name=None):
    """Per-edge message op(x[src], y[dst]): an [E, ...] output."""
    assert compute_type in _MESSAGE, f"unknown compute_type {compute_type!r}"
    fn = _MESSAGE[compute_type]

    def _f(xa, ya, si, di):
        return fn(xa[si.long()], ya[di.long()])
    return apply_op(_f, _ensure_tensor(x), _ensure_tensor(y),
                    _ensure_tensor(src_index), _ensure_tensor(dst_index),
                    op_name="send_uv")


def _host(t):
    return t.numpy() if isinstance(t, Tensor) else np.asarray(t)


def _out(a):
    return Tensor(np.ascontiguousarray(a))


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbor sampling over a CSC graph, on the host (numpy's
    global RNG draws a fresh subgraph each call)."""
    rown, colp, nodes = _host(row), _host(colptr), _host(input_nodes)
    eid_arr = None if eids is None else _host(eids)
    out_n, out_c, out_e = [], [], []
    for nd in nodes.reshape(-1):
        beg, end = int(colp[nd]), int(colp[nd + 1])
        neigh = rown[beg:end]
        idx = np.arange(beg, end)
        if sample_size >= 0 and len(neigh) > sample_size:
            pick = np.random.choice(len(neigh), size=sample_size,
                                    replace=False)
            neigh = neigh[pick]
            idx = idx[pick]
        out_n.append(neigh)
        out_c.append(len(neigh))
        if eid_arr is not None:
            out_e.append(eid_arr[idx])
    out_neighbors = _out(np.concatenate(out_n) if out_n
                         else np.zeros(0, rown.dtype))
    out_count = _out(np.asarray(out_c, np.int32))
    if return_eids:
        assert eid_arr is not None, "return_eids requires eids"
        return out_neighbors, out_count, _out(
            np.concatenate(out_e) if out_e else np.zeros(0, eid_arr.dtype))
    return out_neighbors, out_count


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Relabel the center nodes and their sampled neighbors to
    contiguous local ids: centers first (in x's order), then neighbors
    as first seen."""
    return reindex_heter_graph(x, [neighbors], [count])


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Relabel the center nodes and the neighbor lists of every edge
    type in one id space: centers first, then neighbors as first seen
    across the edge types in list order; the edges of every type are
    concatenated."""
    if len(neighbors) != len(count):
        raise ValueError(
            f"neighbors and count must pair per edge type: got "
            f"{len(neighbors)} neighbor lists vs {len(count)} count lists")
    xa = _host(x).reshape(-1)
    nas = [_host(n).reshape(-1) for n in neighbors]
    cas = [_host(c).reshape(-1) for c in count]
    mapping = {}
    for nd in xa:
        mapping.setdefault(int(nd), len(mapping))
    for na in nas:
        for nd in na:
            mapping.setdefault(int(nd), len(mapping))
    out_nodes = np.fromiter(mapping.keys(), dtype=xa.dtype,
                            count=len(mapping))
    src = [np.asarray([mapping[int(nd)] for nd in na], np.int64)
           for na in nas]
    dst = [np.repeat(np.arange(len(xa), dtype=np.int64), ca) for ca in cas]
    cat = (lambda parts: np.concatenate(parts) if parts  # noqa: E731
           else np.zeros(0, np.int64))
    return _out(cat(src)), _out(cat(dst)), _out(out_nodes)
