"""MoE gates: routing policies (the port of
``paddle_tpu/incubate/distributed/models/moe/gate.py``; reference analog
python/paddle/incubate/distributed/models/moe/gate/ naive_gate.py,
gshard_gate.py, switch_gate.py).  Each gate maps token activations
[T, H] to (top-k gate values [T, K], expert indices [T, K], aux loss).

The top k is a stable descending sort of the softmax (ties to the lower
index, ``lax.top_k``'s order); routing runs in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .....core.tensor import Tensor, apply_op
from .....nn.layer.layers import Layer
from ..... import nn

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


def _gshard_aux(probs, top1_idx, num_experts):
    """GShard load-balancing loss: E * sum(mean_prob * mean_assignment)."""
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top1_idx, num_experts).float(), dim=0)
    return num_experts * torch.sum(me * ce)


def _top_k(probs, k):
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    return srt.values[:, :k], srt.indices[:, :k]


class BaseGate(Layer):
    def __init__(self, d_model: int, num_experts: int, top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.linear = nn.Linear(d_model, num_experts, bias_attr=False)

    def routing(self, logits):
        """torch [T, E] -> (gate_vals [T, K], idx [T, K], aux)."""
        raise NotImplementedError

    def forward(self, x: Tensor):
        logits = self.linear(x)

        def _route(lg):
            return self.routing(lg.float())
        val, idx, aux = apply_op(_route, logits, op_name="moe_gate",
                                 n_outs=3)
        idx.stop_gradient = True
        return val, idx, aux


class NaiveGate(BaseGate):
    """Top-k softmax gate, no aux loss (reference naive_gate.py)."""

    def routing(self, logits):
        probs = torch.softmax(logits, dim=-1)
        val, idx = _top_k(probs, self.top_k)
        val = val / torch.sum(val, dim=-1, keepdim=True)
        return val, idx, logits.new_zeros((), dtype=torch.float32)


class GShardGate(BaseGate):
    """Top-2 gate with the GShard load-balance aux loss
    (gshard_gate.py)."""

    def __init__(self, d_model, num_experts, top_k=2):
        super().__init__(d_model, num_experts, top_k)

    def routing(self, logits):
        probs = torch.softmax(logits, dim=-1)
        val, idx = _top_k(probs, self.top_k)
        val = val / torch.sum(val, dim=-1, keepdim=True)
        aux = _gshard_aux(probs, idx[:, 0], self.num_experts)
        return val, idx, aux


class SwitchGate(BaseGate):
    """Top-1 switch-transformer gate (switch_gate.py)."""

    def __init__(self, d_model, num_experts, top_k=1):
        super().__init__(d_model, num_experts, 1)

    def routing(self, logits):
        probs = torch.softmax(logits, dim=-1)
        val, idx = _top_k(probs, 1)
        aux = _gshard_aux(probs, idx[:, 0], self.num_experts)
        return val, idx, aux
