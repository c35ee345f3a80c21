"""paddle.incubate.nn: the fused layers and functionals (the port of
``paddle_tpu/incubate/nn/``; reference: python/paddle/incubate/nn/ over
the operators/fused/ CUDA corpus).  Each is the reference's composition
of the port's ops, attention through ``F.scaled_dot_product_attention``.
"""
from . import functional
from .fused_transformer import (FusedMultiHeadAttention, FusedFeedForward,
                                FusedTransformerEncoderLayer)
from .fused_linear import FusedLinear, FusedEcMoe
