"""The ported layers: the ``Layer`` base and containers, common,
activation, norm and loss layers."""
