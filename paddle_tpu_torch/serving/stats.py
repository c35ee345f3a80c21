"""Process-wide serving stats — deliberately stdlib-only.

One mutable dict, updated by every engine and router in the process
(the port's copy of ``paddle_tpu/serving/stats.py``; the same names
mean the same counts).  It lives apart from ``engine.py`` so the router
can bump the shared counters without importing the engine.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["STATS", "stats_zero", "serving_stats", "reset_stats"]


def stats_zero() -> Dict[str, float]:
    return {
        "engines": 0, "requests_added": 0, "requests_finished": 0,
        "requests_preempted": 0, "steps": 0, "prefill_tokens": 0,
        "decode_tokens": 0, "peak_running": 0, "pool_bytes": 0,
        # work reuse (prefix cache + speculative decoding)
        "prefix_hit_tokens": 0, "prefix_evicted_pages": 0,
        "spec_proposed": 0, "spec_accepted": 0,
        # resilience counters (engine.py + router.py)
        "shed": 0, "admission_waits": 0, "callback_errors": 0,
        "recoveries": 0, "quarantined": 0, "deadline_expired": 0,
        "cancelled": 0, "failovers": 0, "replicas_dead": 0, "drains": 0,
    }


STATS: Dict[str, float] = stats_zero()


def serving_stats() -> Dict[str, float]:
    return dict(STATS)


def reset_stats() -> None:
    STATS.clear()
    STATS.update(stats_zero())
