"""paddle.incubate.optimizer (the port of
``paddle_tpu/incubate/optimizer/``; reference:
python/paddle/incubate/optimizer/): LookAhead, ModelAverage, LBFGS and
DistributedFusedLamb."""
from .lookahead import LookAhead
from .modelaverage import ModelAverage
from ...optimizer.lbfgs import LBFGS  # noqa: F401 — the same optimizer
from .distributed_fused_lamb import DistributedFusedLamb

__all__ = ["LookAhead", "ModelAverage", "LBFGS", "DistributedFusedLamb"]
