"""Gradient merge, the k-step gradient accumulation meta-optimizer (the
port of ``paddle_tpu/distributed/fleet/gradient_merge.py``; Paddle's
``fleet/meta_optimizers/gradient_merge_optimizer.py``).

Gradients of k micro-steps merge into one optimizer application: a
k-times-larger batch without its memory.  Autograd already accumulates
into ``.grad`` across backwards, so the wrapper keeps the cadence: it
counts ``step()`` calls, lets the inner optimizer step only on every
k-th, averages the merged gradient first when ``avg`` (the default),
and keeps the gradients in between (``clear_grad`` clears only right
after an application).  A static program's ``minimize`` refuses: there
the cadence belongs in the training loop.

``group``: the data-parallel group over which the merged gradient is
averaged at each k-th step, before the inner step (one bucketed
reduction a merged update, ``parallel.average_gradients``); None
leaves the gradients as the backwards made them.
``fleet.distributed_optimizer`` passes the topology's ``dp`` group, and
``fleet.distributed_model``'s ``DataParallel`` then reduces nothing in
the backwards between.
"""
from __future__ import annotations

from ..parallel import average_gradients

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True,
                 group=None):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg
        self._group = group
        self._step_i = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from ...static.program import recording_program
        if recording_program() is not None:
            raise NotImplementedError(
                "gradient_merge with static-mode minimize(): drive the "
                "merge cadence from the training loop instead (eager "
                "backward() + step())")
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._inner._parameter_list]

    def step(self):
        self._step_i += 1
        if self._step_i % self.k_steps:
            return          # keep accumulating; the grads stay
        if self._group is not None:
            average_gradients(self._inner._parameter_list, self._group)
        if self.avg and self.k_steps > 1:
            for p in self._inner._parameter_list:
                if p.grad is not None:
                    p.grad = p.grad * (1.0 / self.k_steps)
        self._inner.step()
        self._inner.clear_grad()

    def clear_grad(self, set_to_zero=True):
        # only a boundary (just applied) clear is real: between
        # applications the merged gradients must survive the loop's
        # step(); clear_grad() idiom
        if self._step_i % self.k_steps == 0:
            self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        # the merged grads are not optimizer state: a checkpoint taken
        # mid-merge resumes at the last boundary
        sd = self._inner.state_dict()
        sd["__gm_step__"] = self._step_i - (self._step_i % self.k_steps)
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        self._step_i = int(sd.pop("__gm_step__", 0))
        self._inner.set_state_dict(sd)
