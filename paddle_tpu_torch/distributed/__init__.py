"""The distributed train runtime on ``torch.distributed`` (the port of
``paddle_tpu/distributed``'s hybrid-parallel core): the topology
(``mesh``), the rendezvous store and ``init_parallel_env`` (``store``),
collectives over its axis groups (``collective``, ``ppermute`` among
them), tensor parallelism (``tensor_parallel``), ZeRO-1 (``zero``), the
overlapped data-parallel gradient reduction and the 1F1B schedule
arithmetic (``overlap``), the pipeline schedules (``pipeline``), ring
and Ulysses attention (``sequence_parallel``), plans (``plan``), the
one-host launchers (``launch``: ``spawn`` and the pod supervisor),
crash-consistent checkpoints (``fault_tolerance``, ``checkpoint``),
topology-elastic restore (``reshard``), elastic supervision
(``fleet.elastic``) and the multi-process gang runtime (``gang``).  ``models.llama.build_train_step`` is
the train step they serve.  NCCL on the card, gloo for CPU tensors.
"""
from .collective import (ReduceOp, all_gather, all_reduce, all_to_all,
                         barrier, broadcast, ppermute, reduce_scatter)
from .launch import spawn
from .mesh import HybridTopology, ONE_RANK, get_topology, init_mesh
from .plan import Plan, PlanError
from .store import TCPStore, init_parallel_env, shutdown

__all__ = ["HybridTopology", "ONE_RANK", "init_mesh", "get_topology",
           "TCPStore", "init_parallel_env", "shutdown", "spawn",
           "ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "all_to_all", "ppermute", "barrier", "Plan",
           "PlanError"]
