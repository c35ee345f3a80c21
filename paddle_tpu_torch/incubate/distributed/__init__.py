"""paddle.incubate.distributed (the port of
``paddle_tpu/incubate/distributed/``): the eager MoE layer."""
from . import models  # noqa: F401
from .models import moe  # noqa: F401
