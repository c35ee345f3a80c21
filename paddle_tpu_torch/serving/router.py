"""Multi-replica serving front door: the port's copy of
``paddle_tpu/serving/router.py``.

N engine replicas behind one router.  The router owns the request's
*identity* (gid, prompt, delivered tokens, deadline); each engine owns
only the replica-local decode state.  That split is what makes every
resilience path below a replay:

  * **Placement** — live, non-draining replicas ranked by queue load
    with a cache-locality bonus when the prompt's prefix is cached on
    (or was recently placed on) the replica, so shared system prompts
    land together.  A replica that sheds (:class:`AdmissionRejected`)
    is skipped; if every live replica sheds, the rejection propagates
    to the caller — typed, retriable.
  * **Liveness** — every replica heartbeats by making step progress;
    :class:`~paddle_tpu_torch.runtime.health.HeartbeatTracker` declares
    a replica dead when its beat counter stalls past the timeout, and a
    step that raises (or blows ``step_timeout_s``) kills the replica
    immediately.
  * **Failover** — a dead replica's requests are resubmitted to the
    survivors as ``prompt + delivered_tokens`` with the remaining
    token budget: greedy decode makes the continuation equal to the
    uninterrupted stream (token for token over float pages), and
    because the router resumes from what was already *delivered*,
    replay is idempotent — no token is streamed twice.
  * **Drain** — SIGTERM (or an explicit ``drain()``) stops placement
    on the replica and migrates its queued + in-flight requests to
    the survivors, the preemption-notice path.

Engine-terminal failures (quarantine, deadline expiry) are *not*
retried — resubmitting a poison request would just poison the next
replica; the typed error is surfaced on the router request instead.

Replicas of one process share one device and one CUDA context: a
replica that dies by a sticky CUDA error leaves the survivors unusable
too, so in-process failover covers host-side faults, hangs and injected
kills.  Under ``step_timeout_s`` a replica's step runs on
``run_with_deadline``'s worker thread; a step abandoned at its deadline
runs on to its end, and the router ignores every token it still
streams (a stream is fed only by its current placement).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import logging
import signal
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..profiler import exporter as _exporter
from ..profiler import metrics as _metrics, trace as _trace
from ..runtime.health import HeartbeatTracker
from ..runtime.watchdog import record_incident, run_with_deadline
from ..testing.chaos import chaos_point
from . import stats as _stats
from .errors import (AdmissionRejected, DeadlineExceeded,
                     ReplicaUnavailable)
from .scheduler import RequestState

__all__ = ["Router", "RouterRequest", "ReplicaState", "EngineReplica",
           "replica_summary_lines", "reset_replica_stats"]

_LOG = logging.getLogger("paddle_tpu_torch.serving")
_GIDS = itertools.count()

# replicas remember this many recent prompt prefixes for locality
_PREFIX_LRU = 64

# per-replica placement/failure tallies for the "Serving" summary
# block (the process-wide STATS in stats.py stay the aggregate)
_REPLICA_STATS: Dict[str, Dict[str, int]] = {}
_REPLICA_KEYS = ("placed", "shed", "failovers", "drains", "dead")


def _replica_stat(name: str, key: str, n: int = 1) -> None:
    stats = _REPLICA_STATS.setdefault(name, dict.fromkeys(_REPLICA_KEYS, 0))
    stats[key] += n


def replica_summary_lines() -> List[str]:
    """Per-replica rows for the "Serving" summary block; empty when no
    router has placed anything this process."""
    lines: List[str] = []
    for name in sorted(_REPLICA_STATS):
        s = _REPLICA_STATS[name]
        lines.append(
            f"  replica {name}: placed={s['placed']} shed={s['shed']} "
            f"failovers={s['failovers']} drains={s['drains']} "
            f"dead={s['dead']}")
    return lines


def reset_replica_stats() -> None:
    _REPLICA_STATS.clear()


class ReplicaState(enum.Enum):
    LIVE = "live"
    DRAINING = "draining"   # finishes nothing new; requests migrated
    DEAD = "dead"


@dataclasses.dataclass
class EngineReplica:
    name: str
    engine: object                      # LLMEngine
    state: ReplicaState = ReplicaState.LIVE
    beats: int = 0                      # liveness counter (step progress)
    prefixes: OrderedDict = dataclasses.field(
        default_factory=OrderedDict)    # prefix key -> None (LRU)


@dataclasses.dataclass
class RouterRequest:
    """One stream as the caller sees it, replica placement aside."""

    gid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int]
    on_token: Optional[Callable]        # (gid, token, finished)
    tokens: List[int] = dataclasses.field(default_factory=list)
    replica: Optional[str] = None       # current placement
    rid: Optional[int] = None           # engine-local id
    finished: bool = False
    error: Optional[BaseException] = None
    deadline_abs: Optional[float] = None  # router clock
    migrations: int = 0
    arrival_s: Optional[float] = None     # router clock, at submit()
    first_token_s: Optional[float] = None  # fleet TTFT observation

    @property
    def done(self) -> bool:
        return self.finished or self.error is not None


class Router:
    """Spread an open-loop request stream over N engine replicas.

    ``engines`` may be LLMEngine instances or (name, engine) pairs;
    ``heartbeat_timeout`` is the silence (on ``clock``) after which a
    replica with a stalled beat counter is declared dead;
    ``step_timeout_s`` optionally bounds each replica's step wall-clock
    via ``run_with_deadline`` (a blown budget kills the replica);
    ``locality_prefix`` is the prompt-prefix length used for
    cache-locality placement.

    ``autoscaler`` attaches an
    :class:`~paddle_tpu_torch.serving.autoscale.AutoscalePolicy`: the router
    feeds it every admission attempt and first-token latency, asks it
    for a verdict once per step, and surfaces the result
    (``last_recommendation``, ``serve_fleet_*`` metrics, a
    ``route/autoscale`` trace event on every non-hold).  Recommend-only
    by default; ``autoscale_apply=True`` additionally *applies* the
    one action that needs no new hardware — scale-down drains the
    least-loaded live replica (idempotent: drain() no-ops on anything
    already draining).  Scale-up stays a recommendation: provisioning
    a replica is the operator's move (or ``add_replica()``).
    """

    def __init__(self, engines, *, names: Optional[List[str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_timeout: float = 10.0,
                 step_timeout_s: Optional[float] = None,
                 locality_prefix: int = 8,
                 autoscaler=None, autoscale_apply: bool = False):
        self._clock = clock
        self.autoscaler = autoscaler
        self.autoscale_apply = bool(autoscale_apply)
        self.last_recommendation = None
        self.step_timeout_s = step_timeout_s
        self.locality_prefix = int(locality_prefix)
        self._replicas: "OrderedDict[str, EngineReplica]" = OrderedDict()
        pairs = []
        for i, e in enumerate(engines):
            if isinstance(e, tuple):
                pairs.append(e)
            else:
                pairs.append((names[i] if names else f"replica{i}", e))
        for name, eng in pairs:
            self._replicas[name] = EngineReplica(name=name, engine=eng)
        if not self._replicas:
            raise ValueError("router needs at least one engine replica")
        self._tracker = HeartbeatTracker(heartbeat_timeout, clock=clock)
        self._requests: Dict[int, RouterRequest] = {}
        # (replica, rid) -> rr: the active placement index
        self._placed: Dict[Tuple[str, int], RouterRequest] = {}
        # submitted but currently unplaceable (mid-failover overload)
        self._orphans: Deque[RouterRequest] = deque()
        self._steps = 0

        _exporter.maybe_serve("router", self)

    # -- introspection ---------------------------------------------------
    def replica_states(self) -> Dict[str, str]:
        return {n: r.state.value for n, r in self._replicas.items()}

    def live_replicas(self) -> List[str]:
        return [n for n, r in self._replicas.items()
                if r.state is ReplicaState.LIVE]

    def output_of(self, gid: int) -> List[int]:
        return list(self._requests[gid].tokens)

    def error_of(self, gid: int) -> Optional[BaseException]:
        return self._requests[gid].error

    def is_finished(self, gid: int) -> bool:
        return self._requests[gid].finished

    def has_work(self) -> bool:
        if self._orphans:
            return True
        return any(not rr.done for rr in self._requests.values())

    # -- placement -------------------------------------------------------
    def _prefix_key(self, prompt: List[int]) -> Tuple[int, ...]:
        return tuple(prompt[:self.locality_prefix])

    def _rank_replicas(self, prompt: List[int]) -> List[EngineReplica]:
        """Live replicas, least-loaded first, with a cache-locality
        bonus.  When a replica's engine runs a prefix cache, the bonus
        is the *real* hit statistic — ``engine.prefix_lookup(prompt)``
        asks the radix trie how many prompt tokens it would serve
        without prefill, scaled to [0, 1] — so shared-system-prompt
        traffic converges on the replica already holding those pages.
        Without a cache the bonus is 0.5 for a recently-placed prompt
        prefix (LRU)."""
        key = self._prefix_key(prompt)
        ranked = []
        for rep in self._replicas.values():
            if rep.state is not ReplicaState.LIVE:
                continue
            sch = rep.engine.scheduler
            load = sch.num_waiting + sch.num_running
            lookup = getattr(rep.engine, "prefix_lookup", None)
            hit = lookup(prompt) if lookup is not None else 0
            if hit > 0:
                bonus = min(hit / max(len(prompt), 1), 1.0)
            elif key in rep.prefixes:
                bonus = 0.5
            else:
                bonus = 0.0
            score = float(load) - bonus
            ranked.append((score, len(ranked), rep))
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [rep for _, _, rep in ranked]

    def _place(self, rr: RouterRequest) -> bool:
        """Try to seat rr on the best live replica.  False when no
        replica could take it (all shed, or none live)."""
        prompt = rr.prompt + rr.tokens
        remaining = rr.max_new_tokens - len(rr.tokens)
        deadline_s = None
        if rr.deadline_abs is not None:
            deadline_s = rr.deadline_abs - self._clock()
            if deadline_s <= 0:
                rr.error = DeadlineExceeded(
                    f"request {rr.gid} deadline passed during "
                    f"placement ({len(rr.tokens)} tokens streamed)")
                return True  # terminal — nothing to place
        for rep in self._rank_replicas(prompt):
            try:
                rid = rep.engine.add_request(
                    prompt, remaining, eos_token_id=rr.eos_token_id,
                    on_token=self._stream_cb(rr, rep.name),
                    deadline_s=deadline_s)
            except AdmissionRejected:
                _replica_stat(rep.name, "shed")
                if _metrics.enabled():
                    _metrics.counter("serve_router_shed_total",
                                     "Placements refused by a shedding "
                                     "replica", replica=rep.name).inc()
                continue
            key = self._prefix_key(prompt)
            rep.prefixes[key] = None
            rep.prefixes.move_to_end(key)
            while len(rep.prefixes) > _PREFIX_LRU:
                rep.prefixes.popitem(last=False)
            rr.replica, rr.rid = rep.name, rid
            self._placed[(rep.name, rid)] = rr
            _replica_stat(rep.name, "placed")
            if _metrics.enabled():
                _metrics.counter("serve_router_placed_total",
                                 "Requests seated on a replica",
                                 replica=rep.name).inc()
            _trace.event("route/place", kind="router", gid=rr.gid,
                         replica=rep.name, rid=rid,
                         migration=rr.migrations)
            return True
        return False

    def _stream_cb(self, rr: RouterRequest, name: str) -> Callable:
        def cb(rid, token, finished):
            if self._placed.get((name, rid)) is not rr:
                # a stale placement: a step abandoned at its deadline
                # finishing after its replica was declared dead
                return
            if rr.first_token_s is None:
                rr.first_token_s = self._clock()
                if (self.autoscaler is not None
                        and rr.arrival_s is not None):
                    self.autoscaler.observe_ttft(
                        rr.first_token_s - rr.arrival_s,
                        t=rr.first_token_s)
            rr.tokens.append(int(token))
            if finished:
                rr.finished = True
            if rr.on_token is not None:
                rr.on_token(rr.gid, int(token), bool(finished))
        return cb

    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit one stream; returns its gid.  Raises
        :class:`AdmissionRejected` when every live replica sheds and
        :class:`ReplicaUnavailable` when none is live."""
        now = self._clock()
        if self.autoscaler is not None:
            # offered load: shed and unplaceable submissions still
            # count — the forecast must see the demand we turn away
            self.autoscaler.observe_arrival(t=now)
        if not self.live_replicas():
            raise ReplicaUnavailable("no live replica to place on")
        rr = RouterRequest(
            gid=next(_GIDS), prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id, on_token=on_token,
            arrival_s=now,
            deadline_abs=(None if deadline_s is None
                          else now + float(deadline_s)))
        if not self._place(rr):
            raise AdmissionRejected(
                f"all {len(self.live_replicas())} live replicas are "
                f"shedding — retry with backoff")
        self._requests[rr.gid] = rr
        return rr.gid

    def add_replica(self, name: str, engine) -> None:
        """Attach one new live replica (the scale-up provisioning
        hook): placement sees it from the next submit/step."""
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already attached")
        self._replicas[name] = EngineReplica(name=name, engine=engine)
        _trace.event("route/replica_added", kind="router",
                     replica=name)
        if _metrics.enabled():
            _metrics.counter("serve_replicas_added_total",
                             "Replicas attached after construction",
                             replica=name).inc()

    # -- liveness / failure handling -------------------------------------
    def observe_beat(self, name: str) -> None:
        """External-replica hook: record one unit of step progress for
        a replica the router does not step in-process."""
        self._replicas[name].beats += 1

    def check_health(self) -> List[str]:
        """Declare replicas whose beat counter stalled past the
        heartbeat timeout dead (observer-clock rule — no cross-host
        clock needed) and fail their requests over.  Returns newly
        dead replica names."""
        newly = []
        for name, rep in self._replicas.items():
            if rep.state is not ReplicaState.LIVE:
                continue
            silent = self._tracker.observe(name, rep.beats)
            if silent > self._tracker.timeout_s:
                self._mark_dead(name, reason=(
                    f"heartbeat silent {silent:.1f}s "
                    f"(> {self._tracker.timeout_s:.1f}s)"))
                newly.append(name)
        return newly

    def _active_on(self, name: str) -> List[RouterRequest]:
        return [rr for (rep, _), rr in list(self._placed.items())
                if rep == name and not rr.done]

    def _mark_dead(self, name: str, reason: str) -> None:
        rep = self._replicas[name]
        if rep.state is ReplicaState.DEAD:
            return
        rep.state = ReplicaState.DEAD
        self._tracker.forget(name)
        _stats.STATS["replicas_dead"] += 1
        _replica_stat(name, "dead")
        _trace.event("route/replica_dead", kind="router", replica=name,
                     reason=reason[:200])
        record_incident("serve_replica_dead", replica=name,
                        reason=reason[:200])
        if _metrics.enabled():
            _metrics.counter("serve_replica_dead_total",
                             "Replicas declared dead",
                             replica=name).inc()
        victims = self._active_on(name)
        _LOG.warning("replica %s dead (%s); failing over %d request(s)",
                     name, reason, len(victims))
        for rr in victims:
            self._failover(rr)

    def _failover(self, rr: RouterRequest) -> None:
        """Move one in-flight stream off its (dead/draining) replica.
        Idempotent by construction: the resubmitted prompt is
        ``prompt + delivered``, so the continuation starts exactly
        after the last token the caller already received."""
        src = rr.replica
        self._placed.pop((rr.replica, rr.rid), None)
        rr.replica = rr.rid = None
        rr.migrations += 1
        _stats.STATS["failovers"] += 1
        if src is not None:
            _replica_stat(src, "failovers")
        _trace.event("route/failover", kind="router", gid=rr.gid,
                     src=src, delivered=len(rr.tokens))
        if _metrics.enabled():
            _metrics.counter("serve_failovers_total",
                             "In-flight requests migrated off a dead "
                             "or draining replica",
                             replica=(src or "none")).inc()
        if len(rr.tokens) >= rr.max_new_tokens or rr.finished:
            rr.finished = True
            return
        if not self._place(rr):
            self._orphans.append(rr)  # retried every step

    def drain(self, name: str) -> int:
        """Preemption notice for one replica: stop placing on it and
        migrate its queued + in-flight requests to live replicas.
        Returns the number of requests migrated."""
        rep = self._replicas[name]
        if rep.state is not ReplicaState.LIVE:
            return 0
        rep.state = ReplicaState.DRAINING
        _stats.STATS["drains"] += 1
        _replica_stat(name, "drains")
        _trace.event("route/drain", kind="router", replica=name)
        record_incident("serve_replica_drain", replica=name)
        if _metrics.enabled():
            _metrics.counter("serve_drains_total",
                             "Replica drains (preemption notices)",
                             replica=name).inc()
        victims = self._active_on(name)
        for rr in victims:
            # the replica is still alive — release its pages/slot so
            # the remaining steps (if any) don't waste them
            rep.engine.cancel(rr.rid)
            self._failover(rr)
        return len(victims)

    def install_sigterm_drain(self, name: Optional[str] = None):
        """SIGTERM → drain: ``name`` when the notice is for one
        replica, else every live replica (whole-process preemption).
        Chains any previously-installed handler."""
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            targets = [name] if name is not None else self.live_replicas()
            for t in targets:
                self.drain(t)
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)
        return _handler

    # -- the step loop ---------------------------------------------------
    def step(self) -> List[int]:
        """One router iteration: step every live replica (each step is
        a heartbeat), harvest completions and engine-terminal errors,
        fail over replicas that died, retry orphans.  Returns the gids
        that finished this step."""
        finished_gids: List[int] = []
        self._steps += 1
        for name in list(self._replicas):
            rep = self._replicas[name]
            if rep.state is not ReplicaState.LIVE:
                continue
            try:
                chaos_point(f"serve.replica.{name}.step",
                            step=self._steps, replica=name)
                if self.step_timeout_s is not None:
                    rids = run_with_deadline(
                        rep.engine.step, self.step_timeout_s,
                        phase=f"serve.replica.{name}", dump=False)
                else:
                    rids = rep.engine.step()
            except Exception as exc:  # noqa: BLE001 — replica failure
                self._mark_dead(name, reason=f"{type(exc).__name__}: "
                                             f"{exc}")
                continue
            rep.beats += 1
            for rid in rids:
                rr = self._placed.get((name, rid))
                if rr is not None:
                    rr.finished = True
                    finished_gids.append(rr.gid)
            # engine-terminal states (quarantine, deadline, cancel)
            # surface on the router request — never retried
            for rr in self._active_on(name):
                st = rep.engine.state_of(rr.rid)
                if st is RequestState.FAILED:
                    rr.error = rep.engine.error_of(rr.rid)
                    self._placed.pop((name, rr.rid), None)
                elif st is RequestState.CANCELLED:
                    rr.error = rr.error or DeadlineExceeded(
                        f"request {rr.gid} cancelled on {name}")
                    self._placed.pop((name, rr.rid), None)
        self.check_health()
        for _ in range(len(self._orphans)):
            rr = self._orphans.popleft()
            if rr.done:
                continue
            if not self._place(rr):
                self._orphans.append(rr)
                break  # nobody can take them this step
        if self.autoscaler is not None:
            self._autoscale_step()
        return finished_gids

    def _autoscale_step(self) -> None:
        """Ask the policy for a verdict and surface it; with
        ``autoscale_apply``, act on scale-down by draining the
        least-loaded live replica (one per step — drains migrate
        work, so pace them)."""
        live = self.live_replicas()
        rec = self.autoscaler.recommend(len(live), t=self._clock())
        self.last_recommendation = rec
        if _metrics.enabled():
            _metrics.gauge("serve_fleet_live_replicas",
                           "Live replicas behind the router").set(
                len(live))
            _metrics.gauge("serve_fleet_target_replicas",
                           "Autoscaler-recommended fleet size").set(
                rec.target_replicas)
            _metrics.gauge("serve_fleet_forecast_rps",
                           "EWMA-forecast offered load").set(
                rec.forecast_rps)
            for w, b in rec.burn.items():
                if b is not None:
                    _metrics.gauge(
                        "serve_fleet_burn_rate",
                        "SLO error-budget burn rate",
                        window=f"{w:g}s").set(b)
        if rec.action == "hold":
            return
        _trace.event("route/autoscale", kind="router",
                     action=rec.action, target=rec.target_replicas,
                     live=len(live), reason=rec.reason[:200])
        if _metrics.enabled():
            _metrics.counter("serve_fleet_scale_events_total",
                             "Non-hold autoscaler recommendations",
                             action=rec.action).inc()
        if (rec.action == "scale_down" and self.autoscale_apply
                and len(live) > max(rec.target_replicas, 1)):
            def _load(name: str) -> int:
                sch = self._replicas[name].engine.scheduler
                return sch.num_waiting + sch.num_running
            victim = min(live, key=_load)
            self.drain(victim)
            self.autoscaler.mark_applied(rec)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until every submitted stream is terminal (or
        max_steps); returns gid -> delivered tokens."""
        steps = 0
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return {gid: list(rr.tokens)
                for gid, rr in self._requests.items()}
