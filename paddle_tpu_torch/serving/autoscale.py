"""Fleet service model + online SLO burn-rate autoscaler (stdlib-only;
the port's copy of ``paddle_tpu/serving/autoscale.py``: the same
arithmetic and the same decisions over the same inputs).

:class:`ServiceModel` is a per-replica record of measured step cost and
capacity knobs (``LLMEngine.service_model()`` builds it from the
engine's step wall times); :func:`replicas_for` / :func:`recommend_fleet`
turn it into a replica count for an offered load.

The online side follows the SRE multi-window burn-rate pattern: an
error budget (fraction of requests allowed to miss the TTFT SLO) is
"burning at rate 1.0" when violations exactly spend it.  A fast
window catches spikes, a slow window confirms they are real; scale-up
fires when both burn, or earlier when the arrival-rate EWMA forecast
says the current fleet cannot clear the projected load — add capacity
*before* the SLO is violated, and drain ahead of a predicted trough
instead of reacting to one.

The policy only ever *recommends*.  The router surfaces the
recommendation (``Router(autoscaler=...)``, ``serve_fleet_*``
metrics, :func:`fleet_summary_lines`) and, with
``autoscale_apply=True``, applies the one action that needs no new
hardware: draining a replica on scale-down.  Scale-up provisioning
stays with the operator.

``DEFAULT_PREFILL_CHUNK_S`` / ``DEFAULT_DECODE_STEP_S`` are the
reference's uncalibrated placeholders, kept so that the two packages
agree when nothing was measured; they are no device's step times.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

__all__ = ["ServiceModel", "SLOBurnGauge", "ArrivalForecast",
           "AutoscalePolicy", "Recommendation", "replicas_for",
           "recommend_fleet", "fleet_stats", "reset_fleet_stats",
           "fleet_summary_lines", "DEFAULT_PREFILL_CHUNK_S",
           "DEFAULT_DECODE_STEP_S"]

# Uncalibrated step-cost placeholders (seconds), the reference's own:
# a model built from no measured step carries them with
# ``calibrated=False``.
DEFAULT_PREFILL_CHUNK_S = 0.020
DEFAULT_DECODE_STEP_S = 0.005


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Per-replica service model: the two step costs (the engine runs
    exactly two buckets — Tc=1 decode, Tc=chunk prefill) plus the
    capacity knobs that bound concurrency.  Everything fleet planning
    needs, nothing device-shaped."""

    max_running: int
    chunk: int
    page_size: int
    num_pages: int
    max_model_len: int
    max_queue: int
    prefill_chunk_s: float = DEFAULT_PREFILL_CHUNK_S
    decode_step_s: float = DEFAULT_DECODE_STEP_S
    calibrated: bool = False

    @classmethod
    def from_step_samples(cls, samples: Dict[int, Sequence[float]],
                          *, max_running: int, chunk: int,
                          page_size: int, num_pages: int,
                          max_model_len: int,
                          max_queue: int) -> "ServiceModel":
        """Calibrate from per-bucket step wall times (engine's
        ``_step_wall_s`` or trace ``serve/step`` span durations
        grouped by their ``bucket`` field).  Medians, so one-off
        first-call steps don't poison the model."""
        prefill = _median(samples.get(chunk))
        decode = _median(samples.get(1))
        return cls(
            max_running=int(max_running), chunk=int(chunk),
            page_size=int(page_size), num_pages=int(num_pages),
            max_model_len=int(max_model_len), max_queue=int(max_queue),
            prefill_chunk_s=(prefill if prefill is not None
                             else DEFAULT_PREFILL_CHUNK_S),
            decode_step_s=(decode if decode is not None
                           else DEFAULT_DECODE_STEP_S),
            calibrated=(prefill is not None or decode is not None))

    @classmethod
    def from_breakdown(cls, breakdown: Dict[str, Optional[float]], *,
                       prompt_len: int, new_tokens: int,
                       max_running: int, chunk: int, page_size: int,
                       num_pages: int, max_model_len: int,
                       max_queue: int) -> "ServiceModel":
        """Calibrate from ``slo_report()["breakdown"]`` means: prefill
        mean covers ceil(prompt/chunk) chunk steps, decode mean covers
        the remaining tokens."""
        pre = breakdown.get("prefill_mean_s")
        dec = breakdown.get("decode_mean_s")
        n_chunks = max(_cdiv(max(int(prompt_len), 1), int(chunk)), 1)
        n_decode = max(int(new_tokens) - 1, 1)
        return cls(
            max_running=int(max_running), chunk=int(chunk),
            page_size=int(page_size), num_pages=int(num_pages),
            max_model_len=int(max_model_len), max_queue=int(max_queue),
            prefill_chunk_s=(pre / n_chunks if pre
                             else DEFAULT_PREFILL_CHUNK_S),
            decode_step_s=(dec / n_decode if dec
                           else DEFAULT_DECODE_STEP_S),
            calibrated=bool(pre or dec))

    # -- capacity arithmetic ---------------------------------------------
    @property
    def blocks_per_request(self) -> int:
        return _cdiv(self.max_model_len, self.page_size)

    @property
    def concurrency(self) -> int:
        """Concurrent requests one replica sustains: slot-limited or
        page-pool-limited, whichever binds (page 0 is the reserved
        null page)."""
        pool = (self.num_pages - 1) // max(self.blocks_per_request, 1)
        return max(min(self.max_running, pool), 1)

    def steps_per_request(self, prompt_len: int,
                          new_tokens: int) -> int:
        """Slot-occupancy in engine steps: chunked prefill (the last
        chunk samples the first token), then one decode step per
        remaining token."""
        return (_cdiv(max(int(prompt_len), 1), self.chunk)
                + max(int(new_tokens) - 1, 0))

    def mean_step_s(self, prompt_len: int, new_tokens: int) -> float:
        """Expected cost of one engine step under steady load: a step
        runs the chunk bucket when *any* of the ``concurrency``
        rows is mid-prefill, so the prefill fraction is amortised
        across the batch, not per-row."""
        total = self.steps_per_request(prompt_len, new_tokens)
        pre = _cdiv(max(int(prompt_len), 1), self.chunk)
        row_frac = pre / max(total, 1)
        any_prefill = 1.0 - (1.0 - row_frac) ** self.concurrency
        return (any_prefill * self.prefill_chunk_s
                + (1.0 - any_prefill) * self.decode_step_s)

    def request_service_s(self, prompt_len: int,
                          new_tokens: int) -> float:
        """Unloaded end-to-end service time for one request (no queue
        wait): the TTFT/latency floor the SLO must sit above."""
        pre = _cdiv(max(int(prompt_len), 1), self.chunk)
        return (pre * self.prefill_chunk_s
                + max(int(new_tokens) - 1, 0) * self.decode_step_s)

    def capacity_rps(self, prompt_len: int, new_tokens: int) -> float:
        """Sustained throughput of one replica in requests/s: each
        request occupies a slot for ``steps_per_request`` steps and
        ``concurrency`` slots drain in parallel."""
        total = self.steps_per_request(prompt_len, new_tokens)
        return self.concurrency / (
            total * self.mean_step_s(prompt_len, new_tokens))

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["concurrency"] = self.concurrency
        d["blocks_per_request"] = self.blocks_per_request
        return d


def _median(xs: Optional[Sequence[float]]) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def replicas_for(model: ServiceModel, rate_rps: float, *,
                 prompt_len: int, new_tokens: int,
                 headroom: float = 0.85) -> int:
    """Minimum replicas clearing ``rate_rps`` with ``headroom``
    utilisation margin (queues diverge at utilisation 1.0 — planning
    to 100% *is* the SLO violation)."""
    cap = model.capacity_rps(prompt_len, new_tokens) * headroom
    if rate_rps <= 0 or cap <= 0:
        return 1
    return max(int(math.ceil(rate_rps / cap)), 1)


def recommend_fleet(model: ServiceModel, arrivals, *,
                    headroom: float = 0.85,
                    peak_window_s: float = 5.0) -> Dict[str, object]:
    """The analytic fleet recommendation for a concrete workload
    (``workloads.generate``'s arrivals).  Sized to the *peak* windowed
    rate: a flash crowd's mean rate is a lie."""
    from . import workloads as _workloads
    arrivals = list(arrivals)
    if not arrivals:
        return {"requests": 0, "min_replicas": 1,
                "offered_rps_mean": 0.0, "offered_rps_peak": 0.0,
                "capacity_rps_per_replica": None}
    p = max(len(a.prompt) for a in arrivals)
    n = max(a.max_new_tokens for a in arrivals)
    mean = _workloads.mean_rate(arrivals)
    peak = _workloads.peak_rate(arrivals, window_s=peak_window_s)
    cap = model.capacity_rps(p, n)
    return {
        "requests": len(arrivals),
        "prompt_len": p, "new_tokens": n,
        "offered_rps_mean": round(mean, 6),
        "offered_rps_peak": round(peak, 6),
        "peak_window_s": peak_window_s,
        "capacity_rps_per_replica": round(cap, 6),
        "headroom": headroom,
        "concurrency_per_replica": model.concurrency,
        "min_replicas": replicas_for(model, peak, prompt_len=p,
                                     new_tokens=n, headroom=headroom),
    }


class SLOBurnGauge:
    """Multi-window SLO burn rate.  Each request contributes one
    ok/violation sample; over a window, burn = violation fraction /
    error budget.  1.0 = spending the budget exactly; a fast window
    at 2.0 plus a slow window above 1.0 is the classic page-worthy
    fast-burn signal."""

    def __init__(self, windows_s: Sequence[float] = (30.0, 120.0),
                 budget: float = 0.05):
        if not windows_s:
            raise ValueError("need at least one burn window")
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.budget = float(budget)
        self._samples: Deque[Tuple[float, bool]] = deque()

    def observe(self, ok: bool, t: float) -> None:
        self._samples.append((float(t), bool(ok)))
        horizon = t - self.windows_s[-1]
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def burn_rates(self, now: float) -> Dict[float, Optional[float]]:
        """window -> burn rate, None when the window holds no
        samples (no traffic is not a violation)."""
        out: Dict[float, Optional[float]] = {}
        for w in self.windows_s:
            xs = [ok for (t, ok) in self._samples if t >= now - w]
            if not xs:
                out[w] = None
            else:
                frac = sum(1 for ok in xs if not ok) / len(xs)
                out[w] = frac / self.budget if self.budget > 0 else (
                    math.inf if frac else 0.0)
        return out


class ArrivalForecast:
    """EWMA arrival rate + trend.  ``observe(t)`` per admission
    attempt (offered load — shed requests still count);
    ``forecast(now, horizon_s)`` projects the rate forward so the
    policy can buy capacity *before* the spike lands."""

    def __init__(self, tau_s: float = 10.0):
        self.tau_s = float(tau_s)
        self._rate = 0.0
        self._trend = 0.0
        self._t: Optional[float] = None

    def observe(self, t: float) -> None:
        if self._t is None:
            self._t = float(t)
            return
        dt = max(float(t) - self._t, 1e-9)
        inst = 1.0 / dt
        alpha = 1.0 - math.exp(-dt / self.tau_s)
        prev = self._rate
        self._rate += alpha * (inst - self._rate)
        self._trend += alpha * ((self._rate - prev) / dt - self._trend)
        self._t = float(t)

    def rate(self, now: Optional[float] = None) -> float:
        """Current rate estimate; silence since the last arrival
        decays it (an idle stream must not hold a spike's rate)."""
        if self._t is None:
            return 0.0
        if now is None or now <= self._t:
            return self._rate
        dt = now - self._t
        inst = 1.0 / dt
        if inst >= self._rate:
            return self._rate
        alpha = 1.0 - math.exp(-dt / self.tau_s)
        return self._rate + alpha * (inst - self._rate)

    def forecast(self, now: float, horizon_s: float) -> float:
        r = self.rate(now)
        trend = self._trend if r >= self._rate * 0.5 else 0.0
        return max(r + trend * float(horizon_s), 0.0)


@dataclasses.dataclass
class Recommendation:
    """One autoscaler verdict.  ``applied`` flips when the router
    acts on it (scale-down drain) rather than just surfacing it."""

    action: str                  # "hold" | "scale_up" | "scale_down"
    target_replicas: int
    live_replicas: int
    reason: str
    at_s: float
    forecast_rps: float
    burn: Dict[float, Optional[float]]
    applied: bool = False

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["burn"] = {f"{w:g}s": (None if b is None else round(b, 4))
                     for w, b in self.burn.items()}
        return d


# process-wide fleet stats (the "Fleet" summary block) — same pattern
# as serving/stats.py: one plain dict, cheap to keep unconditionally.
def _fleet_zero() -> Dict[str, float]:
    return {"policies": 0, "arrivals": 0, "ttft_samples": 0,
            "ttft_violations": 0, "recommendations": 0,
            "scale_ups": 0, "scale_downs": 0, "applied": 0,
            "last_target": 0, "last_live": 0,
            "last_forecast_rps": 0.0}


_FLEET: Dict[str, float] = _fleet_zero()


def fleet_stats() -> Dict[str, float]:
    return dict(_FLEET)


def reset_fleet_stats() -> None:
    _FLEET.clear()
    _FLEET.update(_fleet_zero())


def fleet_summary_lines() -> List[str]:
    """The "Fleet" summary block (the reference's Profiler section)."""
    s = _FLEET
    lines = ["Fleet"]
    if not s["policies"]:
        lines.append("  (no AutoscalePolicy instantiated)")
        return lines
    lines.append(
        f"  arrivals: {int(s['arrivals'])}  "
        f"ttft samples: {int(s['ttft_samples'])} "
        f"({int(s['ttft_violations'])} SLO violations)")
    lines.append(
        f"  recommendations: {int(s['recommendations'])}  "
        f"scale-ups: {int(s['scale_ups'])}  "
        f"scale-downs: {int(s['scale_downs'])}  "
        f"applied: {int(s['applied'])}")
    lines.append(
        f"  last: target={int(s['last_target'])} "
        f"live={int(s['last_live'])} "
        f"forecast={s['last_forecast_rps']:.2f} req/s")
    return lines


class AutoscalePolicy:
    """Recommend-only fleet sizing from live signals.

    Feeds: :meth:`observe_arrival` on every admission attempt (offered
    load), :meth:`observe_ttft` on every first token (SLO compliance).
    :meth:`recommend` combines the EWMA forecast with the multi-window
    burn gauge:

      * forecast demand > live capacity  -> scale_up (pre-violation:
        this is the flash-crowd path — the trend term fires while the
        queue is still healthy);
      * fast AND slow windows burning    -> scale_up (the reactive
        backstop when the forecast missed);
      * forecast demand < live capacity, sustained for ``cooldown_s``
        and nothing burning -> scale_down (drain ahead of the trough).

    The clock is injectable and every observe/recommend accepts an
    explicit ``t`` so a simulator or a test can drive it on virtual
    time.
    """

    def __init__(self, model: ServiceModel, *,
                 slo_ttft_s: Optional[float] = None,
                 prompt_len: int = 64, new_tokens: int = 32,
                 budget: float = 0.05,
                 windows_s: Sequence[float] = (30.0, 120.0),
                 horizon_s: float = 15.0, headroom: float = 0.85,
                 min_replicas: int = 1, max_replicas: int = 64,
                 cooldown_s: float = 30.0, burn_fast: float = 2.0,
                 burn_slow: float = 1.0, forecast_tau_s: float = 10.0,
                 up_cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.model = model
        self.slo_ttft_s = slo_ttft_s
        self.prompt_len = int(prompt_len)
        self.new_tokens = int(new_tokens)
        self.horizon_s = float(horizon_s)
        self.headroom = float(headroom)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.burn_fast = float(burn_fast)
        self.burn_slow = float(burn_slow)
        # the reactive +1 bump must be paced: while both windows burn,
        # an unpaced policy adds a replica on EVERY recommend() call
        # (one per router step) and runs away to max_replicas.  One
        # bump per fast window gives the new capacity a chance to show
        # up in the burn signal before the next bump.
        self.up_cooldown_s = (float(windows_s[0] if windows_s else 30.0)
                              if up_cooldown_s is None
                              else float(up_cooldown_s))
        self._clock = clock
        self.gauge = SLOBurnGauge(windows_s, budget)
        self.forecaster = ArrivalForecast(forecast_tau_s)
        self._below_since: Optional[float] = None
        self._last_bump_s: Optional[float] = None
        self.last: Optional[Recommendation] = None
        _FLEET["policies"] += 1

    # -- signal intake ---------------------------------------------------
    def observe_arrival(self, t: Optional[float] = None) -> None:
        self.forecaster.observe(self._clock() if t is None else t)
        _FLEET["arrivals"] += 1

    def observe_ttft(self, ttft_s: float,
                     t: Optional[float] = None) -> None:
        ok = self.slo_ttft_s is None or ttft_s <= self.slo_ttft_s
        self.gauge.observe(ok, self._clock() if t is None else t)
        _FLEET["ttft_samples"] += 1
        if not ok:
            _FLEET["ttft_violations"] += 1

    # -- the verdict -----------------------------------------------------
    def _burning(self, burn: Dict[float, Optional[float]]) -> bool:
        fast_w = self.gauge.windows_s[0]
        slow_w = self.gauge.windows_s[-1]
        fast = burn.get(fast_w)
        slow = burn.get(slow_w)
        return (fast is not None and fast >= self.burn_fast
                and slow is not None and slow >= self.burn_slow)

    def recommend(self, live_replicas: int,
                  t: Optional[float] = None) -> Recommendation:
        now = self._clock() if t is None else t
        live = int(live_replicas)
        fc = self.forecaster.forecast(now, self.horizon_s)
        demand = replicas_for(self.model, fc,
                              prompt_len=self.prompt_len,
                              new_tokens=self.new_tokens,
                              headroom=self.headroom)
        burn = self.gauge.burn_rates(now)
        burning = self._burning(burn)
        target, reason = demand, (
            f"forecast {fc:.2f} req/s needs {demand} replica(s)")
        if burning and target <= live and (
                self._last_bump_s is None
                or now - self._last_bump_s >= self.up_cooldown_s):
            target = live + 1
            self._last_bump_s = now
            reason = (f"SLO burn fast/slow over "
                      f"({self.burn_fast:g}, {self.burn_slow:g}) "
                      f"thresholds — reactive scale-up")
        target = max(self.min_replicas,
                     min(self.max_replicas, target))
        if target > live:
            action = "scale_up"
            self._below_since = None
        elif target < live and not burning:
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= self.cooldown_s:
                action = "scale_down"
                reason += (f" — sustained {self.cooldown_s:g}s below "
                           f"{live} live; drain ahead of the trough")
            else:
                action = "hold"
                target = live
        else:
            action = "hold"
            target = live
            self._below_since = None
        rec = Recommendation(
            action=action, target_replicas=target,
            live_replicas=live, reason=reason, at_s=now,
            forecast_rps=fc, burn=burn)
        self.last = rec
        _FLEET["recommendations"] += 1
        if action == "scale_up":
            _FLEET["scale_ups"] += 1
        elif action == "scale_down":
            _FLEET["scale_downs"] += 1
        _FLEET["last_target"] = target
        _FLEET["last_live"] = live
        _FLEET["last_forecast_rps"] = fc
        return rec

    def mark_applied(self, rec: Recommendation) -> None:
        rec.applied = True
        _FLEET["applied"] += 1
