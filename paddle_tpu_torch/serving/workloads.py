"""Synthetic serving workloads — seeded, deterministic, stdlib-only
(the port's copy of ``paddle_tpu/serving/workloads.py``: the same
arguments give the same request stream, arrival for arrival, as the
JAX package's module).

One place defines what "diurnal" or "flash-crowd" traffic means:
arrival offsets, prompts and token budgets, for a given ``(preset,
n_requests, seed, ...)`` tuple.  ``python -m
paddle_tpu_torch.bench_serve --workload`` replays them on the engine.

Arrival processes are inhomogeneous-Poisson shaped: exactly
``n_requests`` arrivals over ``horizon_s`` whose empirical density
follows the preset's intensity curve (sorted uniform quantiles mapped
through the inverse cumulative intensity — no thinning, so the count
is exact and the draw order is reproducible).

Presets:
  * ``uniform``       — constant rate, unique prompts.
  * ``shared-prefix`` — constant rate, prompts share one of
    ``n_groups`` system-prompt prefixes (prefix-cache traffic).
  * ``diurnal``       — sinusoidal day/night rate swing.
  * ``bursty``        — square-wave on/off bursts.
  * ``flash-crowd``   — steady base load, then a step-function spike
    (everyone asks about the same hot content: spike arrivals share
    a prefix group).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["PRESETS", "Arrival", "validate", "generate",
           "step_schedule", "mean_rate", "peak_rate"]

PRESETS = ("uniform", "shared-prefix", "diurnal", "bursty",
           "flash-crowd")

# intensity-curve shape constants (relative units; the generator
# normalises, so only the ratios matter)
_DIURNAL_SWING = 0.8        # peak/trough amplitude around the mean
_BURST_FACTOR = 4.0         # on-phase rate vs off-phase
_BURST_PERIODS = 5          # on/off cycles per horizon
_FLASH_AT = 0.5             # spike start, fraction of horizon
_FLASH_LEN = 0.2            # spike length, fraction of horizon
_FLASH_FACTOR = 6.0         # spike rate vs base rate
_GRID = 2048                # inverse-CDF resolution


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a synthetic workload.  ``t_s`` is the offset
    from workload start; ``group`` tags shared-prefix cohorts
    (0 = unique prompt)."""

    t_s: float
    prompt: tuple
    max_new_tokens: int
    group: int = 0


def validate(preset: str) -> str:
    """Return ``preset`` or raise ValueError enumerating every valid
    preset."""
    if preset not in PRESETS:
        raise ValueError(
            f"unknown workload preset {preset!r} "
            f"(valid: {' | '.join(PRESETS)})")
    return preset


def _intensity(preset: str) -> Callable[[float], float]:
    """Relative arrival intensity over x in [0, 1]."""
    if preset in ("uniform", "shared-prefix"):
        return lambda x: 1.0
    if preset == "diurnal":
        return lambda x: 1.0 + _DIURNAL_SWING * math.sin(
            2.0 * math.pi * x)
    if preset == "bursty":
        return lambda x: (_BURST_FACTOR if (
            int(x * 2 * _BURST_PERIODS) % 2 == 0) else 1.0)
    if preset == "flash-crowd":
        return lambda x: (_FLASH_FACTOR
                          if _FLASH_AT <= x < _FLASH_AT + _FLASH_LEN
                          else 1.0)
    raise ValueError(preset)  # pragma: no cover — validate() gates


def _inverse_cdf(preset: str) -> List[float]:
    """Grid of the inverse cumulative intensity: _GRID+1 points
    mapping quantile q in [0, 1] -> time fraction x in [0, 1]."""
    fn = _intensity(preset)
    # cumulative trapezoid over a uniform grid
    xs = [i / _GRID for i in range(_GRID + 1)]
    cum = [0.0]
    for i in range(1, len(xs)):
        a, b = fn(xs[i - 1]), fn(xs[i])
        cum.append(cum[-1] + 0.5 * (a + b) / _GRID)
    total = cum[-1]
    inv: List[float] = []
    j = 0
    for i in range(_GRID + 1):
        q = total * i / _GRID
        while j < _GRID and cum[j + 1] < q:
            j += 1
        lo, hi = cum[j], cum[j + 1]
        frac = 0.0 if hi <= lo else (q - lo) / (hi - lo)
        inv.append((j + frac) / _GRID)
    return inv


def _interp(grid: Sequence[float], q: float) -> float:
    q = min(max(q, 0.0), 1.0)
    pos = q * (len(grid) - 1)
    i = min(int(pos), len(grid) - 2)
    frac = pos - i
    return grid[i] * (1.0 - frac) + grid[i + 1] * frac


def in_flash_window(t_s: float, horizon_s: float) -> bool:
    """True when ``t_s`` falls inside the flash-crowd spike window."""
    x = t_s / horizon_s if horizon_s > 0 else 0.0
    return _FLASH_AT <= x < _FLASH_AT + _FLASH_LEN


def generate(preset: str, n_requests: int, *, seed: int = 0,
             horizon_s: float = 60.0, prompt_len: int = 12,
             max_new_tokens: int = 8, vocab: int = 100,
             n_groups: int = 4,
             prefix_len: Optional[int] = None) -> List[Arrival]:
    """Exactly ``n_requests`` arrivals over ``horizon_s`` seconds,
    sorted by time, fully determined by the arguments.  ``vocab``
    bounds prompt token ids (keep it below the serving model's vocab);
    ``prefix_len`` is the shared-prefix length for grouped cohorts
    (default: half the prompt)."""
    validate(preset)
    if n_requests <= 0:
        return []
    rng = random.Random(seed)
    inv = _inverse_cdf(preset)
    if prefix_len is None:
        prefix_len = max(prompt_len // 2, 1)
    prefix_len = min(prefix_len, prompt_len)
    # one shared prefix per group, drawn up front so the group ->
    # prefix mapping is independent of arrival order
    prefixes = [tuple(rng.randrange(1, vocab) for _ in range(prefix_len))
                for _ in range(max(n_groups, 1))]
    quantiles = sorted(rng.random() for _ in range(n_requests))
    out: List[Arrival] = []
    for q in quantiles:
        t = _interp(inv, q) * horizon_s
        group = 0
        if preset == "shared-prefix":
            group = 1 + rng.randrange(max(n_groups, 1))
        elif preset == "flash-crowd" and in_flash_window(t, horizon_s):
            group = 1  # the hot content everyone is asking about
        if group:
            head = prefixes[(group - 1) % len(prefixes)]
            tail = tuple(rng.randrange(1, vocab)
                         for _ in range(prompt_len - len(head)))
            prompt = head + tail
        else:
            prompt = tuple(rng.randrange(1, vocab)
                           for _ in range(prompt_len))
        out.append(Arrival(t_s=t, prompt=prompt,
                           max_new_tokens=max_new_tokens, group=group))
    return out


def step_schedule(arrivals: Sequence[Arrival],
                  total_steps: int) -> Dict[int, List[Arrival]]:
    """Map arrival offsets onto ``total_steps`` engine-step slots
    (step index -> arrivals submitted before that step).  This is how
    a step-driven harness replays a time-based workload without knowing
    wall step duration in advance: relative pacing is preserved,
    absolute time is measured, not assumed."""
    if not arrivals:
        return {}
    span = max(a.t_s for a in arrivals) or 1.0
    sched: Dict[int, List[Arrival]] = {}
    for a in arrivals:
        idx = min(int(a.t_s / span * total_steps), total_steps - 1)
        sched.setdefault(idx, []).append(a)
    return sched


def mean_rate(arrivals: Sequence[Arrival],
              horizon_s: Optional[float] = None) -> float:
    """Mean offered rate in requests/s."""
    if not arrivals:
        return 0.0
    span = horizon_s if horizon_s else (max(a.t_s for a in arrivals)
                                        or 1.0)
    return len(arrivals) / span


def peak_rate(arrivals: Sequence[Arrival],
              window_s: float = 5.0) -> float:
    """Peak offered rate: max sliding-window arrival count / window.
    The number capacity planning must clear — a flash crowd's mean
    rate is a lie."""
    if not arrivals:
        return 0.0
    ts = sorted(a.t_s for a in arrivals)
    best, lo = 0, 0
    for hi in range(len(ts)):
        while ts[hi] - ts[lo] > window_s:
            lo += 1
        best = max(best, hi - lo + 1)
    return best / window_s
