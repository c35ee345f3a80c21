"""paddle.quantization (the port of ``paddle_tpu/quantization/``): QAT
and PTQ over fake quant-dequant with a straight-through gradient, the
observers (absmax, moving average, KL), ``convert`` and its int8
inference layers.

Reference: python/paddle/quantization/ (QuantConfig, QAT, quanters) and
python/paddle/quantization/imperative (ImperativePTQ).  A converted
model exports through ``jit.save`` like any other and serves on
``inference.Predictor`` and the C ABI; ONNX interchange is out of scope
(``onnx.export`` raises)."""
from .functional import (  # noqa: F401
    fake_quant_dequant, quant_tensor, dequant_tensor)
from .quanters import (  # noqa: F401
    BaseQuanter, quanter, QuanterFactory, FakeQuanterWithAbsMaxObserver,
    FakeQuanterWithAbsMaxObserverLayer, AbsmaxObserver,
    MovingAverageAbsmaxObserver, KLObserver)
from .config import QuantConfig, SingleLayerConfig  # noqa: F401
from .qat import (  # noqa: F401
    QAT, PTQ, QuantedWrapper, ObserveWrapper, quant_aware, convert)
from .quantized_layers import (  # noqa: F401
    QuantizedLinear, QuantizedConv2D)

__all__ = [
    "fake_quant_dequant", "quant_tensor", "dequant_tensor",
    "BaseQuanter", "quanter", "QuanterFactory",
    "FakeQuanterWithAbsMaxObserver", "FakeQuanterWithAbsMaxObserverLayer",
    "AbsmaxObserver", "MovingAverageAbsmaxObserver", "KLObserver",
    "QuantConfig", "SingleLayerConfig",
    "QAT", "PTQ", "QuantedWrapper", "ObserveWrapper", "quant_aware",
    "convert", "QuantizedLinear", "QuantizedConv2D",
]
