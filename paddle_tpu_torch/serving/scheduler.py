"""Continuous (in-flight) batching scheduler: the port's copy of
``paddle_tpu/serving/scheduler.py``, with the prefix cache, the
speculative verify rows, the terminal states of deadlines and
quarantine, and the flight recorder's lifecycle events (first token and
every terminal transition).

The running batch is a FIXED array of ``max_running`` slots and every
step is one of two shapes: Tc=1 for pure decode, Tc=chunk when any
prefill chunk is in flight.

The unit of progress is the *fed* counter: every request knows
``prompt + output`` tokens, of which ``fed`` are written to the KV
cache.  A step feeds ``min(chunk, known - fed)`` tokens — a large gap
is chunked prefill, a gap of exactly 1 is a decode step, and a
preempted request (pages freed, ``fed`` reset to 0) re-prefills its
whole history through the same code path.  A step that closes the gap
samples the next token from the last fed position.

Per step boundary:
  * completions free their pages and open their slot;
  * WAITING requests are admitted into free slots when the page pool
    covers their first chunk (continuous admission — no draining
    between "batches"), behind a free-page watermark of one decode
    page per running request so admission cannot starve decode;
  * if the pool cannot cover a running request's next chunk, the
    youngest running request is preempted and requeued at the front.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..profiler import trace as _trace
from .kv_cache import PagedKVCache, _cdiv

__all__ = ["AdmissionGate", "Request", "RequestState", "Scheduler",
           "StepPlan", "ScheduledSeq"]

_IDS = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"   # cooperative cancel at a step boundary
    FAILED = "failed"         # deadline expiry or quarantine; see .error


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_IDS))
    eos_token_id: Optional[int] = None
    on_token: Optional[Callable] = None   # (rid, token, finished) -> None
    state: RequestState = RequestState.WAITING
    fed: int = 0                          # tokens written to kv
    output: List[int] = dataclasses.field(default_factory=list)
    arrival_s: float = 0.0
    admitted_s: Optional[float] = None    # first admission (engine clock)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    deadline_s: Optional[float] = None    # absolute, engine clock
    error: Optional[BaseException] = None  # set when state is FAILED

    @property
    def known(self) -> List[int]:
        return self.prompt + self.output

    @property
    def num_known(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and bool(self.output)
                and self.output[-1] == self.eos_token_id)


@dataclasses.dataclass
class ScheduledSeq:
    request: Request
    slot: int
    q_len: int      # tokens fed this step
    seq_len: int    # kv length after this step (fed + q_len)
    produces: bool  # True when the step closes the gap and samples
    # speculative verify chunk: q_len = 1 + spec where the trailing
    # ``spec`` tokens are draft proposals the target verifies this step
    # (multi-token verification is a short ragged prefill, so the row
    # rides the Tc=chunk bucket)
    spec: int = 0


@dataclasses.dataclass
class StepPlan:
    seqs: List[ScheduledSeq]            # occupied slots only
    bucket: int                         # Tc for this step
    preempted: List[Request] = dataclasses.field(default_factory=list)
    # waiting requests that free slots could seat but the page pool
    # could not cover — they stay queued (never dropped); the engine
    # counts these as admission waits
    admission_blocked: int = 0
    # prompt tokens served from the prefix cache by this step's
    # admissions
    prefix_hit_tokens: int = 0


class AdmissionGate:
    """Watermark-hysteresis shed gate for the bounded admission queue:
    start shedding at ``max_queue`` waiting requests, keep shedding
    until the queue drains below half."""

    def __init__(self, max_queue: int):
        self.max_queue = int(max_queue)
        self.shedding = False

    def check(self, depth: int) -> bool:
        """Advance the hysteresis for one admission attempt at queue
        ``depth``; True means shed it."""
        if self.shedding and depth <= self.max_queue // 2:
            self.shedding = False
        if not self.shedding and depth >= self.max_queue:
            self.shedding = True
        return self.shedding

    @property
    def recover_below(self) -> int:
        return self.max_queue // 2


class Scheduler:
    def __init__(self, kv: PagedKVCache, *, max_running: int = 8,
                 chunk: int = 16, max_model_len: Optional[int] = None):
        self.kv = kv
        self.max_running = int(max_running)
        self.chunk = int(chunk)
        self.max_model_len = int(max_model_len
                                 or kv.max_blocks * kv.page_size)
        self.waiting: Deque[Request] = deque()
        # fixed slot array: index == batch row of the step
        self.slots: List[Optional[Request]] = [None] * self.max_running
        self._slot_of: Dict[int, int] = {}
        # speculative lookahead: when > 0, every pure-decode row is
        # widened to a verify chunk of 1 + spec_k tokens (the engine
        # sets this iff a draft model is attached)
        self.spec_k: int = 0

    # -- queue ----------------------------------------------------------
    def add(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request needs {total} tokens > max_model_len "
                f"{self.max_model_len}")
        if _cdiv(total, self.kv.page_size) > self.kv.allocator.capacity:
            # genuine misconfiguration, caught at admission — this
            # request could never run even alone on an empty pool
            raise ValueError(
                f"single request exceeds pool capacity: {total} tokens "
                f"need {_cdiv(total, self.kv.page_size)} pages, pool "
                f"has {self.kv.allocator.capacity}")
        if not req.prompt:
            raise ValueError("empty prompt")
        self.waiting.append(req)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self._slot_of)

    def has_work(self) -> bool:
        return bool(self.waiting or self._slot_of)

    # -- internals ------------------------------------------------------
    def _q_len(self, req: Request) -> int:
        gap = req.num_known - req.fed
        q = min(self.chunk, gap)
        if (self.spec_k > 0 and gap == 1
                and 1 + self.spec_k <= self.chunk
                and req.fed + 1 + self.spec_k <= self.max_model_len
                and _cdiv(req.fed + 1 + self.spec_k, self.kv.page_size)
                <= self.kv.max_blocks):
            q = 1 + self.spec_k
        return q

    def _try_grow(self, req: Request, target: int) -> bool:
        """grow(), with one LRU sweep of unreferenced cached pages when
        the free list alone cannot cover the target — eviction under
        watermark pressure, before any preemption."""
        if self.kv.grow(req.rid, target):
            return True
        deficit = (self.kv.pages_needed(req.rid, target)
                   - self.kv.allocator.num_free)
        if deficit > 0 and self.kv.evict_cached(deficit):
            return self.kv.grow(req.rid, target)
        return False

    def _evict_youngest(self, but_not: Request) -> Optional[Request]:
        for slot in range(self.max_running - 1, -1, -1):
            req = self.slots[slot]
            if req is None or req is but_not:
                continue
            self._release_slot(req)
            req.state = RequestState.WAITING
            req.fed = 0          # re-prefills its whole history
            self.waiting.appendleft(req)
            return req
        return None

    def _release_slot(self, req: Request) -> None:
        slot = self._slot_of.pop(req.rid)
        self.slots[slot] = None
        if self.kv.prefix is not None and req.fed >= self.kv.page_size:
            # donate the valid full pages (fed tokens of kv) so a
            # preempted request keeps its prefix hit on replay and a
            # finished request seeds future siblings; the trie holds
            # them at refcount "idle", so eviction can still reclaim
            self.kv.donate(req.rid, req.known, req.fed)
        else:
            self.kv.release(req.rid)

    # -- lifecycle ------------------------------------------------------
    def remove(self, req: Request, now_s: float = 0.0,
               state: RequestState = RequestState.CANCELLED,
               error: Optional[BaseException] = None) -> None:
        """Terminal removal at a step boundary (cancel / deadline /
        quarantine): free pages and slot if running, drop from the
        queue if waiting, stamp the terminal state."""
        if req.rid in self._slot_of:
            self._release_slot(req)
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        req.state = state
        req.error = error
        req.finish_s = now_s
        # the terminal trace event is emitted HERE, at the single site
        # every terminal transition funnels through, so "exactly one
        # terminal event per admitted request" holds by construction
        _trace.request_event(state.value, req.rid, t=now_s,
                             tokens=len(req.output),
                             error=(None if error is None
                                    else str(error)[:200]))

    def reset_running(self) -> List[Request]:
        """Pool-rebuild support: demote every running request back to
        WAITING with fed=0 (full history replay), in slot order.  Does
        NOT touch the kv cache — the caller is replacing it wholesale
        (after a failed step the donated pools are suspect)."""
        demoted: List[Request] = []
        for slot in range(self.max_running):
            req = self.slots[slot]
            if req is None:
                continue
            self.slots[slot] = None
            req.state = RequestState.WAITING
            req.fed = 0
            demoted.append(req)
        self._slot_of.clear()
        return demoted

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put requests at the head of the queue, preserving order."""
        for req in reversed(reqs):
            self.waiting.appendleft(req)

    # -- the step boundary ---------------------------------------------
    def finish(self, req: Request, now_s: float = 0.0) -> None:
        """Completion at a step boundary: free pages, open the slot."""
        self._release_slot(req)
        req.state = RequestState.FINISHED
        req.finish_s = now_s
        _trace.request_event("finish", req.rid, t=now_s,
                             tokens=len(req.output))

    def schedule(self) -> StepPlan:
        """Build the next step: grow running requests' tables (with
        preemption), admit from the queue, emit the slot plan."""
        preempted: List[Request] = []

        # 1) running requests first — their next chunk must fit
        for slot in range(self.max_running):
            req = self.slots[slot]
            if req is None:
                continue
            target = req.fed + self._q_len(req)
            while not self._try_grow(req, target):
                victim = self._evict_youngest(but_not=req)
                if victim is None:
                    # alone and still can't grow — another tenant holds
                    # the pages (chaos `exhaust`, a co-located engine):
                    # preempt *itself* rather than crash; add() already
                    # rejected requests that could never fit, so this
                    # replays once pages free up
                    self._release_slot(req)
                    req.state = RequestState.WAITING
                    req.fed = 0
                    self.waiting.appendleft(req)
                    preempted.append(req)
                    break
                preempted.append(victim)

        # 2) continuous admission into free slots, behind a watermark
        # of one decode page per running request.  The prefix cache is
        # consulted first: the matched head of the prompt is borrowed
        # (refcounts bumped, nothing allocated), so the request is
        # charged — in both pages and watermark math — only for its
        # uncached tail.
        admission_blocked = 0
        prefix_hit_tokens = 0
        while self.waiting and self.num_running < self.max_running:
            req = self.waiting[0]
            matched = self.kv.match_prefix(req.rid, req.known)
            if matched:
                req.fed = matched
            first = req.fed + min(self.chunk, req.num_known - req.fed)
            need = self.kv.pages_needed(req.rid, first)
            watermark = sum(
                1 for r in self.slots if r is not None
                and self.kv.pages_needed(r.rid, r.fed + 1))
            deficit = need + watermark - self.kv.allocator.num_free
            if deficit > 0:
                self.kv.evict_cached(deficit)
            if (self.kv.allocator.num_free - need < watermark
                    or not self.kv.grow(req.rid, first)):
                if matched:
                    # undo the borrow: drop the refs (and any pending
                    # COW fork) so the blocked request re-matches when
                    # it is eventually seated
                    self.kv.release(req.rid)
                    req.fed = 0
                admission_blocked = len(self.waiting)
                break
            prefix_hit_tokens += matched
            self.waiting.popleft()
            slot = self.slots.index(None)
            self.slots[slot] = req
            self._slot_of[req.rid] = slot
            req.state = RequestState.RUNNING

        # 3) emit the plan
        seqs: List[ScheduledSeq] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            q_len = self._q_len(req)
            gap = req.num_known - req.fed
            seqs.append(ScheduledSeq(
                request=req, slot=slot, q_len=q_len,
                seq_len=req.fed + q_len,
                produces=req.fed + q_len >= req.num_known,
                spec=q_len - gap if gap == 1 and q_len > 1 else 0))
        bucket = self.chunk if any(s.q_len > 1 for s in seqs) else 1
        return StepPlan(seqs=seqs, bucket=bucket, preempted=preempted,
                        admission_blocked=admission_blocked,
                        prefix_hit_tokens=prefix_hit_tokens)

    def apply(self, plan: StepPlan, next_tokens: Dict[int, object],
              now_s: float = 0.0) -> List[Request]:
        """Commit a computed step: advance fed counters, append sampled
        tokens, fire callbacks, finish completed requests.
        ``next_tokens`` maps slot -> sampled token id for slots whose
        step produced one; a *spec verify* slot maps to the accepted
        token list instead (1..spec+1 tokens, in stream order).
        Returns the requests that finished."""
        finished: List[Request] = []
        for s in plan.seqs:
            req = s.request
            if not s.produces:
                req.fed = s.seq_len
                self.kv.commit(req.rid, req.fed)
                continue
            out = next_tokens[s.slot]
            toks = ([int(t) for t in out] if isinstance(out, (list, tuple))
                    else [int(out)])
            appended = 0
            for tok in toks:
                req.output.append(tok)
                appended += 1
                if req.first_token_s is None:
                    req.first_token_s = now_s
                    _trace.request_event("first_token", req.rid, t=now_s)
                done = req.done
                if req.on_token is not None:
                    req.on_token(req.rid, tok, done)
                if done:
                    break
            # a verify chunk's kv is valid only through the accepted
            # tokens — the rejected tail is stale scratch the next
            # step's feed overwrites before any read.  Non-spec rows
            # keep the exact old bookkeeping: every fed token's kv is
            # real, fed advances by the full chunk.
            req.fed = (s.seq_len - s.q_len + appended if s.spec
                       else s.seq_len)
            self.kv.commit(req.rid, req.fed)
            if req.done:
                finished.append(req)
        for req in finished:
            self.finish(req, now_s)
        return finished
