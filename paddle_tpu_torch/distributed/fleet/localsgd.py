"""LocalSGD: k local steps, then the parameters averaged (the port of
``paddle_tpu/distributed/fleet/localsgd.py``; Paddle's
``fleet/meta_optimizers/localsgd_optimizer.py``).

Ranks step on their own rows with no gradient reduction, and every
k-th step the parameters are averaged over the data-parallel group: one
reduction of the weights per k steps instead of one of the gradients a
step.

- ``localsgd_round(train_step, k_steps, axis)``: one round as a plain
  function, k collective-free calls of ``train_step(params, batch) ->
  (params, aux)`` then one average of the params over the axis' group
  (the reference compiles the same round as a ``lax.scan`` and a
  ``pmean``).
- ``LocalSGDOptimizer(inner, k_steps)``: the eager wrapper; the inner
  optimizer steps every call, the parameters are averaged over the
  group (default: the topology's ``dp`` axis) on every k-th.
"""
from __future__ import annotations

import torch

from .. import collective as C

__all__ = ["localsgd_round", "LocalSGDOptimizer"]


def _average(tensors, group) -> None:
    """Each ``torch.Tensor`` replaced in place by its mean over
    ``group``."""
    with torch.no_grad():
        for t in tensors:
            C._all_reduce(t, op=C.ReduceOp.AVG, group=group)


def localsgd_round(train_step, k_steps: int, axis="dp"):
    """``round_fn(params, batches)``: ``batches`` holds k local batches;
    returns the params averaged over ``axis`` after k local steps (a
    flat dict of tensors, updated as ``train_step`` returns them), and
    the steps' auxiliary outputs."""
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")

    def round_fn(params, batches):
        batches = list(batches)
        if len(batches) != k_steps:
            raise ValueError(f"a round takes {k_steps} batches, got "
                             f"{len(batches)}")
        auxs = []
        for b in batches:
            params, aux = train_step(params, b)
            auxs.append(aux)
        _average(params.values() if isinstance(params, dict) else params,
                 axis)
        return params, auxs

    return round_fn


class LocalSGDOptimizer:
    def __init__(self, inner_optimizer, k_steps: int = 1, group=None):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = inner_optimizer
        self.k_steps = int(k_steps)
        self._group = group
        self._step_i = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        self._inner.step()
        self._step_i += 1
        if self._step_i % self.k_steps == 0:
            self._sync_params()

    def _sync_params(self):
        group = self._group
        if group is None:
            from ..mesh import get_topology
            group = "dp" if get_topology(create=False) is not None else None
        _average([p._t for p in self._inner._parameter_list], group)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._inner._parameter_list]
