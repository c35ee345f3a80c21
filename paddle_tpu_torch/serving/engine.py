"""LLMEngine: the serving front end of the port.

``add_request()`` enqueues, ``step()`` runs one continuous-batching
iteration (schedule -> one ``forward_paged`` call -> sample -> commit),
and streaming happens through per-request ``on_token`` callbacks.  The
engine owns the device page pools; the scheduler and ``PagedKVCache``
own all host-side state.  The batch is always [max_running, Tc] with
Tc in {1, chunk}.  Greedy decode only.

This is the core of ``paddle_tpu/serving/engine.py``.  Not ported yet:
prefix cache, speculative decoding, deadlines and SLO reports, tracing
and metrics, int8 KV pools, and crash recovery.  Without recovery a
failing step raises to the caller: nothing here catches a kernel fault.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama as _llama
from ..models.convert import params_to
from . import stats as _stats
from .errors import AdmissionRejected
from .kv_cache import PagedKVCache, _cdiv
from .scheduler import (AdmissionGate, Request, RequestState, Scheduler,
                        StepPlan)

__all__ = ["LLMEngine", "serving_stats", "reset_stats"]

_LOG = logging.getLogger("paddle_tpu_torch.serving")

_STATS = _stats.STATS
serving_stats = _stats.serving_stats
reset_stats = _stats.reset_stats


class _SafeCallback:
    """Isolates a raising user ``on_token`` callback from the step
    loop: the first exception is logged once, the callback is disarmed,
    and the request's stream (decode, kv pages, completion) stays
    alive."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._dead = False

    def __call__(self, rid, token, finished):
        if self._dead:
            return
        try:
            self._fn(rid, token, finished)
        except Exception as exc:  # noqa: BLE001 — isolation is the point
            self._dead = True
            _STATS["callback_errors"] += 1
            _LOG.warning(
                "on_token callback for request %s raised %r; disarming "
                "the callback, stream continues", rid, exc)


def _sample(logits: torch.Tensor, qlens: torch.Tensor):
    """Argmax at every fed position ([R, Tc] int32; position q_len - 1
    is the sampled token) and the max logit of each row's last fed
    position ([R] f32), which ``step`` checks for non-finite values."""
    last = (qlens.long() - 1).clamp(0, logits.shape[1] - 1)
    rows = logits[torch.arange(logits.shape[0], device=logits.device),
                  last]                                      # [R, V]
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.amax(rows, dim=-1))


class LLMEngine:
    """Continuous-batching serving engine over ``models/llama.py``.

    ``page_size`` tokens per pool page, ``num_pages`` pool pages per
    layer (default: enough for every slot at ``max_model_len``, +1 for
    the reserved null page), ``chunk`` the prefill chunk length (also the
    prefill Tc), ``max_running`` the fixed batch width, ``max_queue`` the
    admission queue bound (default ``8 * max_running``).  Runs on the
    card unless ``device`` names another; with ``cfg.quantized`` "auto"
    (the default) the weights are quantized to int8 at build on CUDA.
    The KV pages have the model's dtype; clock stamps are
    ``time.monotonic``."""

    def __init__(self, cfg, params, *, device=None, max_running: int = 8,
                 chunk: int = 16, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 max_queue: Optional[int] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        params = params_to(params, self.device)
        if _llama._quantized_mode(cfg, self.device):
            params = _llama.quantize_params(cfg, params)
        self.params = params
        self.max_running = int(max_running)
        self.chunk = int(chunk)
        self.page_size = int(page_size)
        self.max_model_len = int(
            min(max_model_len or cfg.max_position_embeddings,
                cfg.max_position_embeddings))
        self.max_blocks = _cdiv(self.max_model_len, self.page_size)
        if num_pages is None:
            num_pages = self.max_running * self.max_blocks + 1
        self.num_pages = int(num_pages)

        self.max_queue = int(max_queue if max_queue is not None
                             else 8 * self.max_running)
        self._gate = AdmissionGate(self.max_queue)
        # per-bucket step wall times (each ending in the
        # device-to-host copy of the sampled tokens)
        self._step_wall_s: Dict[int, List[float]] = {}

        self.kv = PagedKVCache(self.num_pages, self.page_size,
                               self.max_blocks)
        self.scheduler = Scheduler(self.kv, max_running=self.max_running,
                                   chunk=self.chunk,
                                   max_model_len=self.max_model_len)

        L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        self._pool_shape = (L, nkv, self.num_pages, self.page_size, d)
        self._kp = torch.zeros(self._pool_shape, dtype=cfg.dtype,
                               device=self.device)
        self._vp = torch.zeros(self._pool_shape, dtype=cfg.dtype,
                               device=self.device)
        self._pool_bytes = 2 * self._kp.numel() * self._kp.element_size()
        self._requests: Dict[int, Request] = {}
        self._steps = 0
        _STATS["engines"] += 1
        _STATS["pool_bytes"] += self._pool_bytes

    # -- request intake --------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int,
                    eos_token_id: Optional[int] = None,
                    on_token: Optional[Callable] = None) -> int:
        """Enqueue one request; returns its id.  ``on_token(rid, token,
        finished)`` streams every generated token from the step that
        produced it (isolated — a raising callback cannot kill the
        engine).  Raises :class:`AdmissionRejected` (retriable) when the
        bounded queue is shedding."""
        depth = self.scheduler.num_waiting
        if self._gate.check(depth):
            _STATS["shed"] += 1
            raise AdmissionRejected(
                f"admission queue at {depth}/{self.max_queue}; "
                f"shedding until it drains below {self.max_queue // 2} "
                f"— retry with backoff")
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      on_token=(_SafeCallback(on_token)
                                if on_token is not None else None),
                      arrival_s=time.monotonic())
        self.scheduler.add(req)
        self._requests[req.rid] = req
        _STATS["requests_added"] += 1
        return req.rid

    def request(self, rid: int) -> Request:
        """The request record (state, output, clock stamps)."""
        return self._requests[rid]

    def output_of(self, rid: int) -> List[int]:
        return list(self._requests[rid].output)

    def state_of(self, rid: int) -> RequestState:
        return self._requests[rid].state

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def cancel(self, rid: int) -> bool:
        """Cooperative cancellation: takes effect immediately at the
        host level (pages freed, slot opened, queue entry dropped).
        Returns False when the request is already terminal."""
        req = self._requests.get(rid)
        if req is None or req.state not in (RequestState.WAITING,
                                            RequestState.RUNNING):
            return False
        self.scheduler.remove(req, now_s=time.monotonic())
        _STATS["cancelled"] += 1
        return True

    # -- the step --------------------------------------------------------
    @staticmethod
    def _batch_arrays(seqs, R: int, Tc: int, Bmax: int, kv):
        """Host-side input assembly for one step over ``seqs``."""
        tokens = np.zeros((R, Tc), np.int32)
        tbl = np.zeros((R, Bmax), np.int32)
        lens = np.zeros((R,), np.int32)
        qlens = np.zeros((R,), np.int32)
        for s in seqs:
            req = s.request
            tokens[s.slot, :s.q_len] = req.known[req.fed:req.fed + s.q_len]
            tbl[s.slot] = kv.block_row(req.rid)
            lens[s.slot] = s.seq_len
            qlens[s.slot] = s.q_len
        return tokens, tbl, lens, qlens

    def _forward(self, plan: StepPlan, tokens, tbl, lens, qlens
                 ) -> np.ndarray:
        """One device step; returns the sampled tokens [R, Tc].  The
        pools are updated in place."""
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (tokens, tbl, lens, qlens)]
        with torch.no_grad():
            logits, _ = _llama.forward_paged(
                self.cfg, self.params, args[0], self._kp, self._vp,
                args[1], args[2], args[3])
            nxt, chk = _sample(logits, args[3])
        nxt = nxt.cpu().numpy()
        slots = [s.slot for s in plan.seqs]
        chk = chk.cpu().numpy()[slots]
        if not np.all(np.isfinite(chk)):
            raise FloatingPointError(
                f"non-finite logits at step {self._steps} in slots "
                f"{[sl for sl, c in zip(slots, chk) if not np.isfinite(c)]}")
        return nxt

    def step(self) -> List[int]:
        """One continuous-batching iteration.  Returns the request ids
        that finished at this step boundary."""
        plan = self.scheduler.schedule()
        if plan.admission_blocked:
            _STATS["admission_waits"] += 1
        if not plan.seqs:
            return []
        R, Tc = self.max_running, plan.bucket
        tokens, tbl, lens, qlens = self._batch_arrays(
            plan.seqs, R, Tc, self.max_blocks, self.kv)

        t_fwd = time.monotonic()
        nxt = self._forward(plan, tokens, tbl, lens, qlens)
        now = time.monotonic()
        self._step_wall_s.setdefault(Tc, []).append(now - t_fwd)

        out: Dict[int, int] = {}
        prefill = decode = 0
        for s in plan.seqs:
            if s.produces:
                out[s.slot] = int(nxt[s.slot, s.q_len - 1])
            if s.produces and s.q_len == 1:
                decode += 1
            else:
                prefill += s.q_len
        finished = self.scheduler.apply(plan, out, now_s=now)
        self._steps += 1

        _STATS["steps"] += 1
        _STATS["prefill_tokens"] += prefill
        _STATS["decode_tokens"] += decode
        _STATS["requests_preempted"] += len(plan.preempted)
        _STATS["requests_finished"] += len(finished)
        _STATS["peak_running"] = max(_STATS["peak_running"],
                                     len(plan.seqs))
        return [r.rid for r in finished]

    # -- convenience -----------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until all queued/running work completes (or max_steps);
        returns rid -> generated tokens for every request that left the
        WAITING state (including cancelled partials)."""
        steps = 0
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return {rid: list(r.output) for rid, r in self._requests.items()
                if r.state is not RequestState.WAITING}
