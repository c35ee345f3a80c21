"""LookAhead (the port of ``paddle_tpu/incubate/optimizer/lookahead.py``;
reference: python/paddle/incubate/optimizer/lookahead.py): slow weights
that move ``alpha`` of the way to the fast ones every ``k`` steps."""
from __future__ import annotations

import torch

__all__ = ["LookAhead"]


class LookAhead:
    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1 and isinstance(k, int)
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._k_count = 0
        self._slow: dict = {}

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    def __getattr__(self, item):
        if item == "inner_optimizer":  # unpickling probes before __init__
            raise AttributeError(item)
        return getattr(self.inner_optimizer, item)

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._k_count += 1
        if self._k_count == 1:
            # the slow weights start as the params after the first step
            # (reference lookahead.py:235-238), copies: a parameter's
            # storage is updated in place
            for p in self._parameter_list:
                self._slow[id(p)] = p._t.detach().clone()
        if self._k_count % self.k != 0:
            return
        for p in self._parameter_list:
            slow = self._slow.get(id(p))
            if slow is None:  # a param added after the first step
                slow = p._t.detach().clone()
            slow = slow + self.alpha * (p._t - slow)
            self._slow[id(p)] = slow
            p._set_array(slow.to(p._t.dtype))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, *a, **k):
        return self.inner_optimizer.clear_grad(*a, **k)
