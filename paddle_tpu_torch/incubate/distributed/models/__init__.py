"""paddle.incubate.distributed.models: the eager MoE layer."""
from . import moe  # noqa: F401
