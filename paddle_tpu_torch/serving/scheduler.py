"""Continuous (in-flight) batching scheduler: the port's copy of
``paddle_tpu/serving/scheduler.py``, without the flight-recorder calls
and the prefix-cache and speculative-decoding paths (later slices).

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

from .kv_cache import PagedKVCache, _cdiv

__all__ = ["AdmissionGate", "Request", "RequestState", "Scheduler",
           "StepPlan", "ScheduledSeq"]

_IDS = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"   # cooperative cancel at a step boundary


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
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None

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


@dataclasses.dataclass
class StepPlan:
    seqs: List[ScheduledSeq]            # occupied slots only
    bucket: int                         # Tc for this step
    preempted: List[Request] = dataclasses.field(default_factory=list)
    # waiting requests that free slots could seat but the page pool
    # could not cover — they stay queued (never dropped)
    admission_blocked: int = 0


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
        return min(self.chunk, req.num_known - req.fed)

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
        self.kv.release(req.rid)

    # -- lifecycle ------------------------------------------------------
    def remove(self, req: Request, now_s: float = 0.0) -> None:
        """Cancel at a step boundary: free pages and slot if running,
        drop from the queue if waiting, stamp the terminal state."""
        if req.rid in self._slot_of:
            self._release_slot(req)
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        req.state = RequestState.CANCELLED
        req.finish_s = now_s

    # -- the step boundary ---------------------------------------------
    def finish(self, req: Request, now_s: float = 0.0) -> None:
        """Completion at a step boundary: free pages, open the slot."""
        self._release_slot(req)
        req.state = RequestState.FINISHED
        req.finish_s = now_s

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
            while not self.kv.grow(req.rid, target):
                victim = self._evict_youngest(but_not=req)
                if victim is None:
                    # alone and still can't grow — another tenant holds
                    # the pages: preempt *itself* rather than crash;
                    # add() already rejected requests that could never
                    # fit, so this replays once pages free up
                    self._release_slot(req)
                    req.state = RequestState.WAITING
                    req.fed = 0
                    self.waiting.appendleft(req)
                    preempted.append(req)
                    break
                preempted.append(victim)

        # 2) continuous admission into free slots, behind a watermark
        # of one decode page per running request
        admission_blocked = 0
        while self.waiting and self.num_running < self.max_running:
            req = self.waiting[0]
            first = req.fed + min(self.chunk, req.num_known - req.fed)
            need = self.kv.pages_needed(req.rid, first)
            watermark = sum(
                1 for r in self.slots if r is not None
                and self.kv.pages_needed(r.rid, r.fed + 1))
            if (self.kv.allocator.num_free - need < watermark
                    or not self.kv.grow(req.rid, first)):
                admission_blocked = len(self.waiting)
                break
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
            seqs.append(ScheduledSeq(
                request=req, slot=slot, q_len=q_len,
                seq_len=req.fed + q_len,
                produces=req.fed + q_len >= req.num_known))
        bucket = self.chunk if any(s.q_len > 1 for s in seqs) else 1
        return StepPlan(seqs=seqs, bucket=bucket, preempted=preempted,
                        admission_blocked=admission_blocked)

    def apply(self, plan: StepPlan, next_tokens: Dict[int, int],
              now_s: float = 0.0) -> List[Request]:
        """Commit a computed step: advance fed counters, append sampled
        tokens, fire callbacks, finish completed requests.
        ``next_tokens`` maps slot -> sampled token id for slots whose
        step produced one.  Returns the requests that finished."""
        finished: List[Request] = []
        for s in plan.seqs:
            req = s.request
            req.fed = s.seq_len
            self.kv.commit(req.rid, req.fed)
            if not s.produces:
                continue
            tok = int(next_tokens[s.slot])
            req.output.append(tok)
            if req.first_token_s is None:
                req.first_token_s = now_s
            done = req.done
            if req.on_token is not None:
                req.on_token(req.rid, tok, done)
            if done:
                finished.append(req)
        for req in finished:
            self.finish(req, now_s)
        return finished
