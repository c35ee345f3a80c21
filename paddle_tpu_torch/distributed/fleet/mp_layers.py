"""Tensor-parallel layers (the port of
``paddle_tpu/distributed/fleet/mp_layers.py``; Paddle's
``fleet/layers/mpu/mp_layers.py``).

The reference's layers hold full weights annotated for GSPMD, which
splits them and inserts the collectives.  Here each ``mp`` rank holds
its shard, and the collectives are ``distributed.tensor_parallel``'s
(the functional train step's own):

- ``ColumnParallelLinear``: weight ``[in, out/mp]`` and its bias block;
  the input enters through ``enter`` (identity forward, all-reduce of
  the gradient backward); ``gather_output`` all-gathers the output.
- ``RowParallelLinear``: weight ``[in/mp, out]``; an input that is not
  already split (``input_is_parallel`` False) is cut to this rank's
  block; the partial products are all-reduced (``leave``), then the
  whole bias is added.
- ``VocabParallelEmbedding``: rows ``[V/mp, H]``; a lookup outside this
  rank's rows gives zeros, and the ranks' lookups are all-reduced.
- ``ParallelCrossEntropy``: the per-token cross-entropy over logits
  split by vocabulary (``tensor_parallel.cross_entropy``), 0 where the
  label is ``ignore_index``.

Every rank draws the full weight from the global generator (the same
seed on every rank) and keeps its block, so a layer at mp = n holds
exactly the blocks of the layer a world of one draws.  The group is
``mp_group`` (a ``Group``), else the topology's ``mp`` axis.
"""
from __future__ import annotations

import torch

from ...core.tensor import apply_op
from ...nn import initializer as I
from ...nn.layer.layers import Layer, Parameter
from ..collective import Group, group_rank, resolve_group
from ..mesh import get_topology
from ..tensor_parallel import (TensorParallel, cross_entropy, embedding,
                               enter, gather, leave, split)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _mp(mp_group) -> TensorParallel:
    """This rank's place in its tensor-parallel group."""
    group = mp_group if isinstance(mp_group, Group) else "mp"
    if group == "mp" and get_topology(create=False) is None:
        return TensorParallel(None, 1, 0, False)
    size, rank = group_rank(group)
    return TensorParallel(resolve_group(group), size, rank, False)


def _block(layer: Layer, name: str, dim: int, tp: TensorParallel):
    """Replace the full parameter ``name`` by this rank's block of
    ``dim``."""
    full = getattr(layer, name)
    if tp.size == 1:
        return
    n = full.shape[dim]
    if n % tp.size:
        raise ValueError(f"{type(layer).__name__}.{name}: dim {dim} of "
                         f"{full.shape} does not split over mp={tp.size}")
    b = n // tp.size
    t = full._t.detach().narrow(dim, tp.rank * b, b).clone()
    p = Parameter(t, trainable=not full.stop_gradient, name=full.name)
    p.is_distributed = True
    setattr(layer, name, p)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._tp = _mp(mp_group)
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        _block(self, "weight", 1, self._tp)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter(
                [out_features], is_bias=True,
                default_initializer=I.Constant(0.0))
            _block(self, "bias", 0, self._tp)

    def forward(self, x):
        tp = self._tp

        def f(a, w, *b):
            if tp.size > 1:
                a = enter(a, tp)
            y = a @ w
            if b:
                y = y + b[0]
            if self.gather_output and tp.size > 1:
                y = gather(y, tp)
            return y
        bias = () if self.bias is None else (self.bias,)
        return apply_op(f, x, self.weight, *bias,
                        op_name="column_parallel_linear")


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._tp = _mp(mp_group)
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        _block(self, "weight", 0, self._tp)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter(
                [out_features], is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, x):
        tp = self._tp

        def f(a, w, *b):
            if tp.size > 1:
                if not self.input_is_parallel:
                    a = split(a, tp)
                y = leave(a @ w, tp)
            else:
                y = a @ w
            return y + b[0] if b else y
        bias = () if self.bias is None else (self.bias,)
        return apply_op(f, x, self.weight, *bias,
                        op_name="row_parallel_linear")


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._tp = _mp(mp_group)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02))
        _block(self, "weight", 0, self._tp)

    def forward(self, x):
        tp = self._tp

        def f(ids, w):
            if tp.size > 1:
                return embedding(ids.long(), w, tp)
            return torch.nn.functional.embedding(ids.long(), w)
        return apply_op(f, x, self.weight, op_name="vocab_parallel_embedding")


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._tp = _mp(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        tp, ignore = self._tp, self.ignore_index

        def f(logits, lab):
            if lab.dim() == logits.dim() and lab.shape[-1] == 1:
                lab = lab.squeeze(-1)
            lab = lab.long()
            valid = lab != ignore
            safe = torch.where(valid, lab, torch.zeros_like(lab))
            if tp.size > 1:
                per = cross_entropy(logits, safe, tp)
            else:
                logp = torch.log_softmax(logits, -1)
                per = -logp.gather(-1, safe[..., None])[..., 0]
            return torch.where(valid, per, torch.zeros_like(per))
        return apply_op(f, input, label, op_name="parallel_cross_entropy")
