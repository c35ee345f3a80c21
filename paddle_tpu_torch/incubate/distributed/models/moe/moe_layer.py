"""MoELayer: mixture of experts with capacity-based dispatch (the port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``; reference
analog python/paddle/incubate/distributed/models/moe/moe_layer.py:260).

Dispatch and combine are dense einsums against a capacity one-hot
tensor (the GShard formulation, as the reference's); the experts run
batched over their stacked parameters through ``torch.func.vmap`` of
``Layer.functional_forward``, so all experts execute as batched
matmuls.  Per-token top-k, capacity drops and the aux loss follow the
reference.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .....core.tensor import Tensor, apply_op
from .....nn.layer.layers import Layer, LayerList
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "moe_dispatch_combine"]


def _capacity(T, K, E, capacity_factor):
    return max(1, int(capacity_factor * T * K / E))


def _positions(gate_idx, E):
    """(the one-hot [T, K, E] int32 of ``gate_idx``, each (token, k)
    assignment's place in its expert's queue [T, K]), in token order."""
    T, K = gate_idx.shape
    onehot = F.one_hot(gate_idx, E).to(torch.int32)            # [T,K,E]
    flat = onehot.reshape(T * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(T, K, E)
    return onehot, torch.sum(pos_in_expert * onehot, dim=-1)   # [T,K]


def moe_dispatch_combine(x, gate_val, gate_idx, expert_fn,
                         num_experts: int, capacity_factor: float = 1.25):
    """The functional core on torch tensors: tokens [T, H] routed to
    ``expert_fn([E, C, H]) -> [E, C, H']``, then combined to [T, H']."""
    T, H = x.shape
    E = num_experts
    K = gate_val.shape[-1]
    C = _capacity(T, K, E, capacity_factor)
    onehot, pos = _positions(gate_idx, E)
    keep = pos < C
    disp = (onehot.bool() & keep[..., None]).to(x.dtype)[..., None] \
        * F.one_hot(torch.where(keep, pos, 0).long(), C).to(x.dtype)[
            :, :, None, :]                                      # [T,K,E,C]
    combine = disp * gate_val[..., None, None].to(x.dtype)
    disp2 = disp.sum(1)                                         # [T,E,C]
    expert_in = torch.einsum("tec,th->ech", disp2, x)           # [E,C,H]
    expert_out = expert_fn(expert_in)                           # [E,C,H']
    return torch.einsum("tkec,ech->th", combine, expert_out)


def dropped_share(gate_idx, num_experts: int, capacity_factor: float):
    """The share of the (token, k) assignments past their expert's
    capacity (the ones the dispatch drops)."""
    idx = getattr(gate_idx, "_t", gate_idx)
    T, K = idx.shape
    C = _capacity(T, K, num_experts, capacity_factor)
    _, pos = _positions(idx, num_experts)
    return float((pos >= C).float().mean())


class MoELayer(Layer):
    """The eager MoE layer over per-expert sub-Layers (moe_layer.py:260
    surface: MoELayer(d_model, experts, gate, top_k)).  The experts'
    parameters are stacked per slot and the experts run under
    ``torch.func.vmap`` over the capacity buffers."""

    def __init__(self, d_model: int, experts: List[Layer],
                 gate: Optional[BaseGate] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01):
        super().__init__()
        self.d_model = d_model
        self.num_experts = len(experts)
        self.experts = LayerList(experts)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        if gate is None:
            gate = GShardGate(d_model, self.num_experts, top_k)
        elif isinstance(gate, str):
            gate = {"naive": NaiveGate, "gshard": GShardGate,
                    "switch": SwitchGate}[gate](d_model, self.num_experts,
                                                top_k)
        self.gate = gate
        self.aux_loss = None
        self.last_gate_idx = None

    def forward(self, x: Tensor) -> Tensor:
        orig_shape = x.shape
        H = orig_shape[-1]
        from .....tensor.manipulation import reshape
        xt = reshape(x, [-1, H])
        gate_val, gate_idx, aux = self.gate(xt)
        self.aux_loss = aux * self.aux_loss_weight
        self.last_gate_idx = gate_idx

        param_lists = [list(e.parameters()) for e in self.experts]
        n_per = len(param_lists[0])
        for pl in param_lists:
            if len(pl) != n_per:
                raise ValueError("experts must be homogeneous")
        flat_params = [p for pl in param_lists for p in pl]
        expert0 = self.experts[0]
        E, cf = self.num_experts, self.capacity_factor

        def _f(xt_a, val_a, idx_a, *params):
            stacked = [torch.stack([params[e * n_per + slot]
                                    for e in range(E)])
                       for slot in range(n_per)]

            def expert_fn(buf):  # [E, C, H]
                return torch.func.vmap(expert0.functional_forward)(
                    stacked, buf)

            return moe_dispatch_combine(xt_a, val_a, idx_a, expert_fn, E, cf)

        out = apply_op(_f, xt, gate_val, gate_idx, *flat_params,
                       op_name="moe_layer")
        return reshape(out, orig_shape[:-1] + [out.shape[-1]])
