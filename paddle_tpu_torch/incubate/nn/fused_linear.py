"""FusedLinear and FusedEcMoe (the port of
``paddle_tpu/incubate/nn/fused_linear.py``; reference:
python/paddle/incubate/nn/layer/fused_linear.py and fused_ec_moe.py).

A fused linear is ``x @ W + b`` in one op; the EC-MoE layer runs every
expert in one batched einsum a projection, the gate's softmax in the
same op."""
from __future__ import annotations

import torch

from ...core.tensor import apply_op
from ...nn.layer.layers import Layer
from ...nn import initializer as I

__all__ = ["FusedLinear", "FusedEcMoe"]


class FusedLinear(Layer):
    """Linear with the fused-gemm-epilogue contract
    (reference: incubate/nn/layer/fused_linear.py FusedLinear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self._transpose_weight = transpose_weight
        wshape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x):
        from .functional import fused_linear
        return fused_linear(x, self.weight, self.bias,
                            transpose_weight=self._transpose_weight)


class FusedEcMoe(Layer):
    """Expert-choice-style fused MoE FFN (reference:
    incubate/nn/layer/fused_ec_moe.py FusedEcMoe): a softmax gate over
    the experts, each expert's two-layer FFN, the weighted combine.
    "gelu" is the tanh approximation, ``jax.nn.gelu``'s default."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        assert act_type in ("gelu", "relu"), \
            f"unsupported act_type {act_type!r}"
        self._act_type = act_type
        self.bmm_weight0 = self.create_parameter(
            [num_experts, hidden_size, inter_size], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bmm_bias0 = self.create_parameter(
            [num_experts, 1, inter_size], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.bmm_weight1 = self.create_parameter(
            [num_experts, inter_size, hidden_size], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bmm_bias1 = self.create_parameter(
            [num_experts, 1, hidden_size], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x, gate):
        """x: [B, S, H]; gate: [B, S, E] logits. Returns [B, S, H]."""
        if self._act_type == "gelu":
            def act(v):
                return torch.nn.functional.gelu(v, approximate="tanh")
        else:
            act = torch.relu

        def _f(xa, ga, w0, b0, w1, b1):
            probs = torch.softmax(ga, dim=-1)                 # [B,S,E]
            h = act(torch.einsum("bsh,ehi->besi", xa, w0) + b0[None])
            out = torch.einsum("besi,eih->besh", h, w1) + b1[None]
            return torch.einsum("bse,besh->bsh", probs, out)

        return apply_op(_f, x, gate, self.bmm_weight0, self.bmm_bias0,
                        self.bmm_weight1, self.bmm_bias1,
                        op_name="fused_ec_moe")
