"""The eager MoE layer and its gates (the port of
``paddle_tpu/incubate/distributed/models/moe``)."""
from .gate import NaiveGate, GShardGate, SwitchGate, BaseGate  # noqa: F401
from .moe_layer import MoELayer, moe_dispatch_combine  # noqa: F401
