"""DistributedFusedLamb (the port of
``paddle_tpu/incubate/optimizer/distributed_fused_lamb.py``; reference:
python/paddle/incubate/optimizer/distributed_fused_lamb.py).  On one
device it is ``Lamb`` with the reference's gradient accumulation: the
mean of ``gradient_accumulation_steps`` micro-steps' gradients, then one
update."""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Lamb

__all__ = ["DistributedFusedLamb"]


class DistributedFusedLamb(Lamb):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 alignment=128, use_master_param_norm=True,
                 gradient_accumulation_steps=1, use_master_acc_grad=True,
                 name=None):
        super().__init__(learning_rate=learning_rate,
                         lamb_weight_decay=lamb_weight_decay,
                         beta1=beta1, beta2=beta2, epsilon=epsilon,
                         parameters=parameters, grad_clip=grad_clip,
                         exclude_from_weight_decay_fn=(
                             exclude_from_weight_decay_fn))
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self._acc_step = 0
        self._acc_grads: dict = {}

    def step(self):
        k = self.gradient_accumulation_steps
        if k <= 1:
            return super().step()
        self._acc_step += 1
        for p in self._parameter_list:
            if p.grad is None:
                continue
            g = p.grad._t.to(torch.float32)
            acc = self._acc_grads.get(id(p))
            self._acc_grads[id(p)] = g if acc is None else acc + g
        if self._acc_step < k:
            self.clear_grad()
            return
        for p in self._parameter_list:
            acc = self._acc_grads.get(id(p))
            if acc is not None:
                p.grad = acc / k
        self._acc_grads = {}
        self._acc_step = 0
        super().step()
