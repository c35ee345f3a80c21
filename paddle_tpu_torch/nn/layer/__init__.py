"""The ported layers: the ``Layer`` base and containers, common,
conv, activation, norm, pooling and loss layers."""
