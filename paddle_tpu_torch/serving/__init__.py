"""Serving for the port: the continuous-batching ``LLMEngine`` over a
paged KV cache (bf16 or int8 pages), with its scheduler, page allocator,
shared-prefix cache, speculative decoding, crash recovery, deadlines and
SLO report, typed errors, process-wide stats and synthetic workloads
(``workloads``); the multi-replica ``Router`` (placement by load and
prefix locality, heartbeat liveness, failover, drain); and fleet
planning (``autoscale``: the per-replica ``ServiceModel``, burn-rate
gauges and the recommend-only ``AutoscalePolicy``)."""
from . import autoscale, workloads
from .autoscale import (AutoscalePolicy, Recommendation, ServiceModel,
                        fleet_stats, recommend_fleet, replicas_for,
                        reset_fleet_stats)
from .engine import (LLMEngine, SLOConfig, reset_stats, serving_stats,
                     summary_lines)
from .errors import (AdmissionRejected, DeadlineExceeded,
                     ReplicaUnavailable, RequestQuarantined,
                     RetriableError, ServingError)
from .kv_cache import (BlockAllocator, PagedKVCache, kv_bytes_per_token,
                       plan_capacity)
from .prefix_cache import PrefixCache
from .router import EngineReplica, ReplicaState, Router, RouterRequest
from .scheduler import AdmissionGate, Request, RequestState, Scheduler
from .spec_decode import SpecDecodeConfig

__all__ = ["LLMEngine", "SLOConfig", "SpecDecodeConfig", "reset_stats",
           "serving_stats", "summary_lines", "AdmissionRejected",
           "DeadlineExceeded", "ReplicaUnavailable", "RequestQuarantined",
           "RetriableError", "ServingError", "BlockAllocator",
           "PagedKVCache", "kv_bytes_per_token", "plan_capacity",
           "PrefixCache", "AdmissionGate", "Request", "RequestState",
           "Scheduler", "workloads", "autoscale", "AutoscalePolicy",
           "Recommendation", "ServiceModel", "fleet_stats",
           "reset_fleet_stats", "recommend_fleet", "replicas_for",
           "Router", "RouterRequest", "ReplicaState", "EngineReplica"]
