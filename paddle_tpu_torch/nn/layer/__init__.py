"""The layers: the ``Layer`` base and containers, common, conv,
activation, norm, pooling, loss, RNN and transformer layers."""
