"""Fleet, the hybrid-parallel training facade (the port of
``paddle_tpu/distributed/fleet/__init__.py``), and elastic training
(``fleet/elastic.py``: heartbeats, scale requests, the elastic
supervisor).

``fleet.init(strategy)`` joins the process group (``init_parallel_env``)
and builds the topology from ``strategy.hybrid_configs``; a second call
in the same world builds another.  ``distributed_model`` wraps the model
in ``DataParallel`` over the topology's ``dp`` group: whenever dp > 1,
and, as in the reference, at mp = pp = 1 (a pass-through at dp = 1).
The reference returns the model as it is once mp or pp > 1, because
GSPMD reduces over dp in the compiled step; here the ranks of a dp
group hold separate gradients at any mp or pp, so the wrapper stays.
``distributed_optimizer`` applies the strategy's meta-optimizers in the
reference's order: LARS swaps a ``Momentum`` for ``LarsMomentum``, then
LocalSGD wraps, then gradient merge wraps; DGC is refused.

Under LocalSGD or gradient merge the wrapper's backward reduces
nothing: LocalSGD averages the parameters every k-th step, and gradient
merge (without LocalSGD) averages the merged gradient over ``dp`` at
its k-th step, so either synchronizes once in k steps.
"""
from __future__ import annotations

from typing import Optional

from ..collective import barrier, get_rank, get_world_size
from ..mesh import HybridTopology, get_topology, init_mesh
from ..parallel import DataParallel, init_parallel_env
from . import elastic, mp_layers, utils  # noqa: F401
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)

__all__ = ["init", "Fleet", "DistributedStrategy", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker",
           "barrier_worker", "VocabParallelEmbedding",
           "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy", "mp_layers", "utils", "elastic",
           "get_rank", "get_world_size"]


class DistributedStrategy:
    """The reference's strategy fields (Paddle's protobuf-backed
    ``fleet/base/distributed_strategy.py``)."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.sharding = False
        self.sharding_configs = {}
        self.lamb = False
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005,
                             "epsilon": 0.0,
                             "exclude_from_weight_decay": []}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        # deep gradient compression: distributed_optimizer refuses it
        self.dgc = False
        self.dgc_configs = {}
        self.find_unused_parameters = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}


_FLEET_STATE = {"strategy": None, "topology": None}


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    """Join the process group and build the topology of
    ``strategy.hybrid_configs`` (``dp_degree`` -1: the ranks the other
    degrees leave)."""
    strategy = strategy or DistributedStrategy()
    init_parallel_env()
    hc = strategy.hybrid_configs
    mp, pp = hc.get("mp_degree", 1), hc.get("pp_degree", 1)
    sharding = hc.get("sharding_degree", 1)
    dp = hc.get("dp_degree", 1)
    if dp == -1:
        dp = get_world_size() // (mp * pp * sharding)
    topo = init_mesh(dp=dp, pp=pp, sharding=sharding, mp=mp)
    _FLEET_STATE["strategy"] = strategy
    _FLEET_STATE["topology"] = topo
    return topo


def get_hybrid_communicate_group() -> Optional[HybridTopology]:
    return _FLEET_STATE["topology"] or get_topology(create=False)


def _syncs_in_optimizer(strategy) -> bool:
    """Whether the strategy's meta-optimizers synchronize the dp ranks
    themselves (LocalSGD, gradient merge)."""
    return bool(getattr(strategy, "localsgd", False)
                or getattr(strategy, "gradient_merge", False))


def distributed_model(model):
    """``model`` wrapped in ``DataParallel`` over the ``dp`` group when
    dp > 1 or mp = pp = 1; otherwise the model as it is.  Under LocalSGD
    or gradient merge its backward reduces nothing."""
    topo = get_hybrid_communicate_group() or get_topology()
    strategy = _FLEET_STATE["strategy"]
    if topo.dp_degree > 1 or (topo.mp_degree == 1 and topo.pp_degree == 1):
        model = DataParallel(model, group=topo.group("dp"),
                             find_unused_parameters=bool(getattr(
                                 strategy, "find_unused_parameters", False)))
        if _syncs_in_optimizer(strategy):
            model._grad_sync = False
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` under the strategy's meta-optimizers (``strategy``,
    else ``init``'s): LARS, then LocalSGD, then gradient merge."""
    strategy = strategy or _FLEET_STATE.get("strategy")
    if strategy is None:
        return optimizer
    if getattr(strategy, "dgc", False):
        raise NotImplementedError(
            "DGC (deep gradient compression) is not supported: it trades "
            "accuracy for bandwidth; use gradient_merge or localsgd to "
            "synchronize less often instead")
    if getattr(strategy, "lars", False):
        from ...optimizer import LarsMomentum, Momentum
        if isinstance(optimizer, Momentum):
            cfg = getattr(strategy, "lars_configs", {}) or {}
            if getattr(optimizer, "_nesterov", False):
                import warnings
                warnings.warn(
                    "strategy.lars replaces Momentum with LarsMomentum, "
                    "which has no nesterov variant; use_nesterov is "
                    "dropped")
            lars = LarsMomentum(
                learning_rate=optimizer._lr,
                momentum=optimizer._momentum,
                parameters=optimizer._parameter_list,
                grad_clip=optimizer._grad_clip,
                lars_coeff=float(cfg.get("lars_coeff", 0.001)),
                lars_weight_decay=float(
                    cfg.get("lars_weight_decay", 0.0005)),
                epsilon=float(cfg.get("epsilon", 0.0)),
                exclude_from_weight_decay=cfg.get(
                    "exclude_from_weight_decay", []))
            # the Momentum's additive L2 stays beside the decay inside
            # the trust ratio
            lars._weight_decay = optimizer._weight_decay
            optimizer = lars
    if getattr(strategy, "localsgd", False):
        from .localsgd import LocalSGDOptimizer
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        optimizer = LocalSGDOptimizer(optimizer,
                                      k_steps=int(cfg.get("k_steps", 1)))
    if getattr(strategy, "gradient_merge", False):
        from .gradient_merge import GradientMergeOptimizer
        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        topo = get_hybrid_communicate_group()
        # under LocalSGD the merged gradients stay local
        group = (topo.group("dp") if topo is not None
                 and not getattr(strategy, "localsgd", False) else None)
        return GradientMergeOptimizer(
            optimizer, k_steps=int(cfg.get("k_steps", 1)),
            avg=bool(cfg.get("avg", True)), group=group)
    return optimizer


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    barrier()


class Fleet:
    """The stateful facade object the module functions stand for."""

    def __init__(self):
        self._strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        init(role_maker, is_collective, strategy, log_level)
        self._strategy = _FLEET_STATE["strategy"]
        return self

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    @property
    def worker_index(self):
        return worker_index()

    @property
    def worker_num(self):
        return worker_num()

    def is_first_worker(self):
        return is_first_worker()

    def barrier_worker(self):
        barrier_worker()

    def get_hybrid_communicate_group(self):
        return get_hybrid_communicate_group()
