"""Process-wide serving stats — deliberately stdlib-only.

One mutable dict, updated by every engine in the process (the port's
copy of ``paddle_tpu/serving/stats.py``, with the keys of the modules
ported so far; the same names mean the same counts).
"""
from __future__ import annotations

from typing import Dict

__all__ = ["STATS", "stats_zero", "serving_stats", "reset_stats"]


def stats_zero() -> Dict[str, float]:
    return {
        "engines": 0, "requests_added": 0, "requests_finished": 0,
        "requests_preempted": 0, "steps": 0, "prefill_tokens": 0,
        "decode_tokens": 0, "peak_running": 0, "pool_bytes": 0,
        # admission control and callback isolation
        "shed": 0, "admission_waits": 0, "callback_errors": 0,
        "cancelled": 0,
    }


STATS: Dict[str, float] = stats_zero()


def serving_stats() -> Dict[str, float]:
    return dict(STATS)


def reset_stats() -> None:
    STATS.clear()
    STATS.update(stats_zero())
