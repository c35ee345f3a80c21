"""Serving for the port: the continuous-batching ``LLMEngine`` over a
paged KV cache, with its scheduler, page allocator, typed errors and
process-wide stats."""
from .engine import LLMEngine, reset_stats, serving_stats
from .errors import (AdmissionRejected, DeadlineExceeded,
                     ReplicaUnavailable, RequestQuarantined,
                     RetriableError, ServingError)
from .kv_cache import (BlockAllocator, PagedKVCache, kv_bytes_per_token,
                       plan_capacity)
from .scheduler import Request, RequestState, Scheduler

__all__ = ["LLMEngine", "reset_stats", "serving_stats",
           "AdmissionRejected", "DeadlineExceeded", "ReplicaUnavailable",
           "RequestQuarantined", "RetriableError", "ServingError",
           "BlockAllocator", "PagedKVCache", "kv_bytes_per_token",
           "plan_capacity", "Request", "RequestState", "Scheduler"]
