"""QAT / PTQ model transforms and quanted-layer wrappers (the port of
``paddle_tpu/quantization/qat.py``).

Reference analog: python/paddle/quantization/qat.py:22 (QAT.quantize),
wrapper.py:20 (ObserveWrapper), imperative/ptq.py (ImperativePTQ).

"quantize" is a model-to-model transform that wraps matmul/conv layers
with fake-quant layers; `convert` freezes the quanters, bakes the weight
scales, and with ``to_int8=True`` swaps in the int8 layers of
``quantized_layers`` that ``jit.save`` exports and the ``inference``
Predictor serves."""
from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from ..nn.layer.layers import Layer
from .config import QuantConfig
from .quanters import QuanterFactory

__all__ = ["QAT", "PTQ", "QuantedWrapper", "ObserveWrapper",
           "quant_aware", "convert"]


class QuantedWrapper(Layer):
    """Wraps a Linear/Conv layer: fake-quants the activation and the
    weight, then runs the original layer with the quantized weight (the
    reference's QuantedLinear/QuantedConv2D in nn/quant/quant_layers.py)."""

    def __init__(self, layer: Layer, activation_quanter=None,
                 weight_quanter=None):
        super().__init__()
        self._layer = layer
        self.activation_quanter = activation_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x, *args, **kwargs):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        if self.weight_quanter is not None and hasattr(self._layer,
                                                       "weight"):
            w = self._layer.weight
            qw = self.weight_quanter(w)
            # substitute the quantized TENSOR so the inner layer's ops
            # consume the fake-quant node and the STE backward reaches w
            object.__setattr__(self._layer, "weight", qw)
            try:
                return self._layer(x, *args, **kwargs)
            finally:
                object.__setattr__(self._layer, "weight", w)
        return self._layer(x, *args, **kwargs)


class ObserveWrapper(Layer):
    """reference: wrapper.py:20 — observe-only wrapper used by PTQ."""

    def __init__(self, observer, observed: Layer, observe_input=True):
        super().__init__()
        self._observer = observer
        self._observed = observed
        self._observe_input = observe_input

    def forward(self, x, *args, **kwargs):
        if self._observe_input:
            x = self._observer(x)
            return self._observed(x, *args, **kwargs)
        out = self._observed(x, *args, **kwargs)
        return self._observer(out)


def _make(factory):
    if factory is None:
        return None
    if isinstance(factory, QuanterFactory):
        return factory._instance()
    return factory() if isinstance(factory, type) else factory


def _transform(model: Layer, config: QuantConfig, wrapper_cls,
               full_name=""):
    for name, sub in list(model._sub_layers.items()):
        child_name = f"{full_name}.{name}" if full_name else name
        mapped = config.qat_layer_mappings.get(type(sub))
        if mapped is not None:
            _replace(model, name, mapped(sub))
            continue
        if config._is_quantifiable(sub):
            cfg = config._get_config_by_layer(sub, child_name)
            if cfg is not None and (cfg.activation is not None
                                    or cfg.weight is not None):
                _replace(model, name, wrapper_cls(
                    sub, _make(cfg.activation), _make(cfg.weight)))
                continue
        _transform(sub, config, wrapper_cls, child_name)
    return model


def _replace(model: Layer, name: str, layer: Layer):
    """Swap sublayer ``name`` for ``layer`` in the registry and as the
    attribute the parent's forward reads."""
    model._sub_layers[name] = layer
    if model.__dict__.get(name) is not None:
        object.__setattr__(model, name, layer)


class QAT:
    """reference: qat.py:22."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: Layer, inplace=False) -> Layer:
        assert model.training, \
            "QAT.quantize expects a train-mode model (call model.train())"
        if not inplace:
            model = copy.deepcopy(model)
        return _transform(model, self._config, QuantedWrapper)

    def convert(self, model: Layer, inplace=False, to_int8=False) -> Layer:
        return convert(model, inplace=inplace, to_int8=to_int8)


class PTQ:
    """Post-training quantization: insert observers, run calibration data
    through the model, then convert (reference: imperative/ptq.py)."""

    def __init__(self, config: QuantConfig = None):
        if config is None:
            from .quanters import QuanterFactory, AbsmaxObserver
            config = QuantConfig(
                activation=QuanterFactory(AbsmaxObserver),
                weight=QuanterFactory(AbsmaxObserver))
        self._config = config

    def quantize(self, model: Layer, inplace=False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        model.eval()
        return _transform(model, self._config, QuantedWrapper)

    def convert(self, model: Layer, inplace=False, to_int8=False) -> Layer:
        return convert(model, inplace=inplace, to_int8=to_int8)


def convert(model: Layer, inplace=False, to_int8=False) -> Layer:
    """Freeze quanters.

    Default: replace each QuantedWrapper by its inner layer with the
    weight fake-quantized in place (the exported graph carries the
    quantization error) and record scales as buffers.

    ``to_int8=True`` — the QuantizationFreezePass form: wrappers whose
    BOTH quanters hold scales (PTQ-calibrated or QAT-trained) become
    int8 inference layers (quantized_layers.QuantizedLinear /
    QuantizedConv2D): int8 weights in the artifact, activation
    quantization at the calibrated scale, an int8 product for Linear.
    The converted model exports via jit.save and serves on the Python
    Predictor and the C ABI unchanged.
    """
    from ..core.tensor import Tensor
    if not inplace:
        model = copy.deepcopy(model)
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, QuantedWrapper):
            if to_int8 and _to_int8_layer(model, name, sub):
                continue
            inner = sub._layer
            wq = sub.weight_quanter
            if wq is not None and hasattr(inner, "weight"):
                # bake quantization error directly from the observed scale
                # (observer-type quanters have identity forwards, so calling
                # wq(weight) would be a no-op for PTQ)
                from .functional import fake_quant_dequant
                with torch.no_grad():
                    inner.weight._set_array(fake_quant_dequant(
                        inner.weight._t.detach(), wq.scales()._t,
                        bits=wq.bit_length, quant_axis=wq.quant_axis))
                try:
                    inner.register_buffer("weight_scale",
                                          Tensor(wq.scales()._t.clone()))
                except (AttributeError, ValueError, TypeError) as e:
                    # quanter never observed / exposes no scales: the
                    # bake above already happened, only the exported
                    # scale buffer is skipped
                    logging.getLogger(__name__).debug(
                        "convert: no weight_scale buffer for %s: %r",
                        name, e)
            aq = sub.activation_quanter
            if aq is not None:
                try:
                    inner.register_buffer("activation_scale",
                                          Tensor(aq.scales()._t.clone()))
                except (AttributeError, ValueError, TypeError) as e:
                    logging.getLogger(__name__).debug(
                        "convert: no activation_scale buffer for %s: %r",
                        name, e)
            _replace(model, name, inner)
        else:
            convert(sub, inplace=True, to_int8=to_int8)
    return model


def _to_int8_layer(model, name, wrapper) -> bool:
    """Try the int8 freeze for one wrapper; False -> fall back to the
    fake-quant bake (missing scales, unsupported layer/axis)."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    from .quantized_layers import QuantizedConv2D, QuantizedLinear

    wq, aq = wrapper.weight_quanter, wrapper.activation_quanter
    if wq is None or aq is None:
        return False
    act_scale = aq.scales()._t.detach().cpu().numpy()
    if float(np.max(np.abs(act_scale))) == 0.0:
        raise ValueError(
            f"convert(to_int8=True): layer {name!r} has an all-zero "
            "activation scale — run calibration batches through the "
            "observed model (PTQ) or train the QAT model first; "
            "freezing now would saturate every activation to +-127")
    for q, what in ((aq, "activation"), (wq, "weight")):
        # fake quanters init their scale to a plausible-looking 1.0;
        # only the _updated flag distinguishes trained from untouched
        if getattr(q, "_updated", None) is False:
            raise ValueError(
                f"convert(to_int8=True): layer {name!r}'s {what} "
                "quanter never observed data (scale is its init, not a "
                "measurement) — train the QAT model before freezing")
    inner = wrapper._layer
    try:
        if isinstance(inner, Linear):
            _replace(model, name, QuantizedLinear.from_observed(
                inner, wq, aq))
            return True
        if isinstance(inner, Conv2D):
            _replace(model, name, QuantizedConv2D.from_observed(
                inner, wq, aq))
            return True
    except ValueError as e:
        import warnings
        warnings.warn(f"convert(to_int8=True): {name!r} falls back to "
                      f"fake-quant baking: {e}")
    return False


def quant_aware(model: Layer, config: QuantConfig = None,
                inplace=False) -> Layer:
    """Convenience one-call QAT entry (the paddleslim-style API)."""
    if config is None:
        from .quanters import FakeQuanterWithAbsMaxObserver
        q = FakeQuanterWithAbsMaxObserver()
        config = QuantConfig(activation=q, weight=q)
    return QAT(config).quantize(model, inplace=inplace)
