"""Fused transformer layers (the port of
``paddle_tpu/incubate/nn/fused_transformer.py``; reference:
python/paddle/incubate/nn/layer/fused_transformer.py): the parameters of
the fused ops, each forward one call of ``incubate.nn.functional``."""
from __future__ import annotations

from ...nn.layer.layers import Layer
from ...nn import initializer as I
from . import functional as FF


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr,
            default_initializer=I.XavierUniform())
        self.qkv_bias = self.create_parameter(
            [3, num_heads, self.head_dim], attr=qkv_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr,
            default_initializer=I.Constant(1.0))
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr,
            default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter(
            [embed_dim], attr=ln_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return FF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            training=self.training, num_heads=self.num_heads)


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate \
            if act_dropout_rate is not None else dropout_rate
        self._epsilon = epsilon
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        self.ln1_scale = self.create_parameter(
            [d_model], default_initializer=I.Constant(1.0))
        self.ln1_bias = self.create_parameter(
            [d_model], is_bias=True, default_initializer=I.Constant(0.0))
        self.ln2_scale = self.create_parameter(
            [d_model], default_initializer=I.Constant(1.0))
        self.ln2_bias = self.create_parameter(
            [d_model], is_bias=True, default_initializer=I.Constant(0.0))

    def forward(self, src, cache=None):
        return FF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            self.linear1_bias, self.linear2_bias,
            self.ln1_scale, self.ln1_bias, self.ln2_scale, self.ln2_bias,
            self.act_dropout_rate, self.dropout_rate, self.activation,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead,
            dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate
            if attn_dropout_rate is not None else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation,
            act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)
