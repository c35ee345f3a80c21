"""QuantConfig (the port of ``paddle_tpu/quantization/config.py``;
reference: python/paddle/quantization/config.py:59).

Maps layers → (activation quanter, weight quanter) by three precedence
levels: per-layer instance, per-name prefix, per-type; plus a global
default. Also carries custom quanted-layer mappings."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from ..nn.layer.layers import Layer
from .quanters import QuanterFactory

__all__ = ["QuantConfig", "SingleLayerConfig"]


class SingleLayerConfig:
    """reference: config.py:34."""

    def __init__(self, activation: Optional[QuanterFactory],
                 weight: Optional[QuanterFactory]):
        self.activation = activation
        self.weight = weight

    def __str__(self):
        return f"activation: {self.activation}\nweight: {self.weight}"


class QuantConfig:
    def __init__(self, activation: Optional[QuanterFactory] = None,
                 weight: Optional[QuanterFactory] = None):
        self._global_config = SingleLayerConfig(activation, weight) \
            if (activation is not None or weight is not None) else None
        self._layer_configs: List[Tuple[List[Layer], SingleLayerConfig]] = []
        self._name_configs: List[Tuple[List[str], SingleLayerConfig]] = []
        self._type_configs: Dict[type, SingleLayerConfig] = {}
        self._qat_layer_mapping: Dict[type, type] = {}
        self._customized_leaves: List[type] = []

    # -- registration (reference: config.py add_layer_config:101,
    #    add_name_config:145, add_type_config:189) --
    def add_layer_config(self, layer: Union[Layer, List[Layer]],
                         activation=None, weight=None):
        layers = layer if isinstance(layer, list) else [layer]
        self._layer_configs.append(
            (layers, SingleLayerConfig(activation, weight)))

    def add_name_config(self, layer_name: Union[str, List[str]],
                        activation=None, weight=None):
        names = layer_name if isinstance(layer_name, list) else [layer_name]
        self._name_configs.append(
            (names, SingleLayerConfig(activation, weight)))

    def add_type_config(self, layer_type: Union[type, List[type]],
                        activation=None, weight=None):
        types = layer_type if isinstance(layer_type, list) else [layer_type]
        cfg = SingleLayerConfig(activation, weight)
        for t in types:
            assert isinstance(t, type) and issubclass(t, Layer)
            self._type_configs[t] = cfg

    def add_qat_layer_mapping(self, source: type, target: type):
        """reference: config.py:233 — replace `source` layers with the
        custom quantization-aware `target` during QAT.quantize."""
        assert isinstance(source, type) and issubclass(source, Layer)
        self._qat_layer_mapping[source] = target

    def add_customized_leaf(self, layer_type: type):
        self._customized_leaves.append(layer_type)

    @property
    def qat_layer_mappings(self):
        return dict(self._qat_layer_mapping)

    @property
    def customized_leaves(self):
        return list(self._customized_leaves)

    # -- resolution --
    def _get_config_by_layer(self, layer: Layer,
                             full_name: str = "") -> Optional[
                                 SingleLayerConfig]:
        for layers, cfg in self._layer_configs:
            if any(l is layer for l in layers):
                return cfg
        for names, cfg in self._name_configs:
            if any(full_name == n or full_name.startswith(n + ".")
                   or full_name.endswith("." + n) for n in names):
                return cfg
        cfg = self._type_configs.get(type(layer))
        if cfg is not None:
            return cfg
        return self._global_config

    def _is_quantifiable(self, layer: Layer) -> bool:
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv1D, Conv2D, Conv3D
        quantables = (Linear, Conv1D, Conv2D, Conv3D)
        return isinstance(layer, quantables) or \
            type(layer) in self._qat_layer_mapping
