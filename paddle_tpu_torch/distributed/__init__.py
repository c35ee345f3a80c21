"""``paddle.distributed`` on ``torch.distributed`` (the port of
``paddle_tpu/distributed``).

The hybrid-parallel core: the topology (``mesh``), the rendezvous store
(``store``), collectives over its axis groups (``collective``,
``ppermute`` among them), tensor parallelism (``tensor_parallel``),
ZeRO-1 (``zero``), the overlapped data-parallel gradient reduction and
the 1F1B schedule arithmetic (``overlap``), the pipeline schedules
(``pipeline``), ring and Ulysses attention (``sequence_parallel``),
plans (``plan``), the one-host launchers (``launch``: ``spawn`` and the
pod supervisor), crash-consistent checkpoints (``fault_tolerance``,
``checkpoint``), topology-elastic restore (``reshard``), elastic
supervision (``fleet.elastic``) and the multi-process gang runtime
(``gang``).  ``models.llama.build_train_step`` is the train step they
serve.

The eager API a Paddle training script calls: the collective facade
over ``Tensor`` (``Group``, ``new_group``, ``all_reduce`` ...
``collective``), ``init_parallel_env`` / ``ParallelEnv`` /
``DataParallel`` (``parallel``), the RNG tracker (``random``),
``recompute``, ``fleet`` (strategy, tensor-parallel layers,
meta-optimizers), ``io`` and ``spawn`` (``launch_utils``).  NCCL on
the card, gloo for CPU tensors and for ranks that share a card.
"""
from . import checkpoint, fault_tolerance, gang, io, launch  # noqa: F401
from . import overlap, pipeline, reshard  # noqa: F401
from .collective import (Group, ReduceOp, all_gather, all_gather_object,
                         all_reduce, all_to_all, alltoall, alltoall_single,
                         barrier, broadcast, broadcast_object_list,
                         destroy_process_group, get_backend, get_group,
                         get_rank, get_world_size, gloo_barrier,
                         gloo_release, irecv, is_initialized, isend,
                         new_group, ppermute, recv, reduce, reduce_scatter,
                         scatter, scatter_object_list, send, stream, wait)
from .fault_tolerance import CheckpointManager, PreemptionHandler
from .launch_utils import spawn
from .mesh import HybridTopology, ONE_RANK, get_topology, init_mesh
from .parallel import (DataParallel, ParallelEnv, init_parallel_env,
                       shutdown)
from .plan import Plan, PlanError
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
from .recompute import recompute, recompute_sequential
from .reshard import restore_resharded
from .store import TCPStore
from . import fleet  # noqa: E402

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce",
    "all_gather", "all_gather_object", "broadcast", "reduce", "scatter",
    "alltoall", "all_to_all", "alltoall_single", "send", "recv", "isend",
    "irecv", "reduce_scatter", "barrier", "get_backend",
    "gloo_init_parallel_env", "shutdown_process_group", "split",
    "get_rank", "get_world_size", "is_initialized", "destroy_process_group",
    "wait", "stream", "init_parallel_env", "shutdown", "ParallelEnv",
    "DataParallel", "broadcast_object_list", "scatter_object_list",
    "gloo_barrier", "gloo_release", "io", "HybridTopology", "ONE_RANK",
    "init_mesh", "get_topology", "TCPStore", "ppermute",
    "RNGStatesTracker", "get_rng_state_tracker",
    "model_parallel_random_seed", "fleet", "spawn", "launch", "recompute",
    "recompute_sequential", "pipeline", "fault_tolerance",
    "CheckpointManager", "PreemptionHandler", "reshard",
    "restore_resharded", "checkpoint", "overlap", "Plan", "PlanError",
    "gang",
]


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Join a gloo process group on the CPU as rank ``rank_id`` of
    ``rank_num``, through the store at ``server_endpoint``
    (``host:port``; rank 0 serves it)."""
    return init_parallel_env(device="cpu", backend="gloo", rank=rank_id,
                             world_size=rank_num, master=server_endpoint)


def shutdown_process_group(group=None):
    """Paddle's ``shutdown_process_group``: ``destroy_process_group``."""
    return destroy_process_group(group)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Paddle's ``split`` (``fleet/layers/mpu/mp_ops.py``): ``x`` through
    a new column- (``axis`` 1) or row-parallel (``axis`` 0) linear of
    ``size`` = [in, out], or a vocab-parallel embedding of ``size`` =
    [vocab, width], split over the ``mp`` group."""
    if operation == "linear":
        if axis == 1:
            layer = fleet.ColumnParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False, gather_output=gather_out)
        else:
            layer = fleet.RowParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False)
        return layer(x)
    if operation == "embedding":
        return fleet.VocabParallelEmbedding(size[0], size[1],
                                            weight_attr=weight_attr)(x)
    raise ValueError(f"split: unknown operation {operation!r}")
