"""ModelAverage (the port of
``paddle_tpu/incubate/optimizer/modelaverage.py``; reference:
python/paddle/incubate/optimizer/modelaverage.py): a running float32 sum
of the parameters; ``apply()`` swaps the average in, ``restore()`` the
weights back."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ModelAverage"]

F32 = torch.float32


class ModelAverage:
    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        assert parameters is not None, "parameters is required"
        self._parameter_list = list(parameters)
        self.avg_rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self._sum: dict = {}
        self._count = 0
        self._backup: dict = {}

    @staticmethod
    def _f32(p):
        # a copy: a parameter's storage is updated in place
        return p._t.detach().to(F32, copy=True)

    @torch.no_grad()
    def step(self):
        """Add the current weights to the sums (call it after the
        optimizer's step); past ``max_average_window`` steps the sums
        restart from the current weights."""
        self._count += 1
        for p in self._parameter_list:
            acc = self._sum.get(id(p))
            self._sum[id(p)] = self._f32(p) if acc is None \
                else acc + p._t.to(F32)
        if self._count > self.max_window:
            for p in self._parameter_list:
                self._sum[id(p)] = self._f32(p)
            self._count = 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights in (a context manager, like the
        reference's)."""
        self._backup = {id(p): p._t.detach().clone()
                        for p in self._parameter_list}
        n = max(1, self._count)
        for p in self._parameter_list:
            acc = self._sum.get(id(p))
            if acc is not None:
                p._set_array((acc / n).to(p._t.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        for p in self._parameter_list:
            if id(p) in self._backup:
                p._set_array(self._backup[id(p)])
        self._backup = {}
