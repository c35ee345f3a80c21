"""Serving for the port: the continuous-batching ``LLMEngine`` over a
paged KV cache (bf16 or int8 pages), with its scheduler, page allocator,
shared-prefix cache, speculative decoding, crash recovery, deadlines and
SLO report, typed errors, process-wide stats and synthetic workloads
(``workloads``)."""
from .engine import LLMEngine, SLOConfig, reset_stats, serving_stats
from .errors import (AdmissionRejected, DeadlineExceeded,
                     ReplicaUnavailable, RequestQuarantined,
                     RetriableError, ServingError)
from .kv_cache import (BlockAllocator, PagedKVCache, kv_bytes_per_token,
                       plan_capacity)
from .prefix_cache import PrefixCache
from .scheduler import Request, RequestState, Scheduler
from .spec_decode import SpecDecodeConfig

__all__ = ["LLMEngine", "SLOConfig", "SpecDecodeConfig", "reset_stats",
           "serving_stats", "AdmissionRejected", "DeadlineExceeded",
           "ReplicaUnavailable", "RequestQuarantined", "RetriableError",
           "ServingError", "BlockAllocator", "PagedKVCache",
           "kv_bytes_per_token", "plan_capacity", "PrefixCache", "Request",
           "RequestState", "Scheduler"]
