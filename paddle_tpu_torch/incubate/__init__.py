"""paddle.incubate (the port of ``paddle_tpu/incubate/``): the fused nn
layers and functionals, the autograd extras, the optimizer wrappers,
the softmax-mask fusions, the graph ops under their incubate names and
``identity_loss``; ``asp`` (2:4 sparsity) and ``distributed`` (the
eager MoE layer).  ``autotune`` raises: it comes with ROADMAP A item 8.
"""
from . import nn  # noqa: F401
from . import autograd  # noqa: F401
from . import asp  # noqa: F401
from . import autotune  # noqa: F401
from . import distributed  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401

# reference: incubate.graph_* are the pre-paddle.geometric names of the
# same ops (python/paddle/incubate/operators/graph_send_recv.py etc.)
from ..geometric import (segment_sum, segment_mean,  # noqa: F401
                         segment_max, segment_min)
from ..geometric import send_u_recv as graph_send_recv  # noqa: F401
from ..geometric import sample_neighbors as graph_sample_neighbors  # noqa
from ..geometric import reindex_graph as graph_reindex  # noqa: F401

__all__ = ["nn", "autograd", "asp", "autotune", "optimizer",
           "LookAhead", "ModelAverage",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "graph_sample_neighbors", "graph_reindex",
           "graph_khop_sampler", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss"]


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis (reference:
    incubate/operators/softmax_mask_fuse.py)."""
    import torch
    from ..core.tensor import apply_op
    from ..ops.registry import _ensure_tensor
    return apply_op(lambda a, m: torch.softmax(a + m, dim=-1),
                    _ensure_tensor(x), _ensure_tensor(mask),
                    op_name="softmax_mask_fuse")


def softmax_mask_fuse_upper_triangle(x, name=None):
    """A causal softmax over [..., S, S] scores: above the diagonal the
    dtype's ``finfo.min`` (reference: softmax_mask_fuse_upper_triangle)."""
    import torch
    from ..core.tensor import apply_op
    from ..ops.registry import _ensure_tensor

    def f(a):
        s = a.shape[-1]
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=a.device))
        dt = a.dtype if a.is_floating_point() else torch.float32
        neg = torch.tensor(torch.finfo(dt).min, dtype=a.dtype,
                           device=a.device)
        return torch.softmax(torch.where(causal, a, neg), dim=-1)
    return apply_op(f, _ensure_tensor(x),
                    op_name="softmax_mask_fuse_upper_triangle")


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbor sampling (reference:
    incubate/operators/graph_khop_sampler.py): ``sample_neighbors`` hop
    after hop, each hop's frontier the new neighbors in the order first
    seen, then one reindex over the union.  Returns (edge_src, edge_dst,
    sample_index, reindex_nodes), on the host's numpy like the
    reference's."""
    import numpy as np
    from ..core.tensor import Tensor
    from ..geometric import sample_neighbors

    def host(t):
        return t.numpy() if isinstance(t, Tensor) else np.asarray(t)

    all_src, all_dst = [], []
    frontier = input_nodes
    for k in sample_sizes:
        neighbors, counts = sample_neighbors(row, colptr, frontier,
                                             sample_size=k)[:2]
        all_src.append(host(neighbors))
        all_dst.append(np.repeat(host(frontier), host(counts)))
        flat = all_src[-1]
        _, first = np.unique(flat, return_index=True)
        frontier = Tensor(flat[np.sort(first)])
    src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
    union = np.concatenate([host(input_nodes), src])
    _, first = np.unique(union, return_index=True)
    sample_index = union[np.sort(first)]
    remap = {int(v): i for i, v in enumerate(sample_index)}
    src_re = np.asarray([remap[int(v)] for v in src], np.int64)
    dst_re = np.asarray([remap[int(v)] for v in dst], np.int64)
    return (Tensor(src_re), Tensor(dst_re), Tensor(sample_index),
            Tensor(np.arange(len(sample_index), dtype=np.int64)))


def identity_loss(x, reduction="none"):
    """Marks a value as the loss with an explicit reduction (reference:
    incubate.identity_loss; 1 = sum, 2 = mean, 0 / "none" = as is)."""
    from ..tensor import math as _m
    red = {0: "none", 1: "sum", 2: "mean"}.get(reduction, reduction)
    if red == "sum":
        return _m.sum(x)
    if red == "mean":
        return _m.mean(x)
    return x
