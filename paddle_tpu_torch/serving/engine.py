"""LLMEngine: the serving front end of the port.

``add_request()`` enqueues, ``step()`` runs one continuous-batching
iteration (schedule -> one ``forward_paged`` call -> sample -> commit),
and streaming happens through per-request ``on_token`` callbacks.  The
engine owns the device page pools; the scheduler and ``PagedKVCache``
own all host-side state.  The batch is always [max_running, Tc] with
Tc in {1, chunk}.  Greedy decode only.

This is ``paddle_tpu/serving/engine.py`` with its int8 KV pools
(``kv_dtype="int8"``), shared-prefix cache (``prefix_cache``),
speculative decoding (``spec``), deadlines and SLO report (``slo``,
``clock``) and crash recovery:

  * **Deadlines** — per-request absolute deadlines on the engine's
    injectable monotonic clock; expiry at a step boundary is a terminal
    FAILED with :class:`~.errors.DeadlineExceeded`.  TTFT and
    request-latency samples back ``slo_report()``.
  * **Crash recovery** — the step's device work runs under the
    ``serve.step`` watchdog phase and a same-named chaos point.  Any
    step failure (a device error, an injected fault, a call that came
    back past its deadline, non-finite logits) is classified, the pools
    (half written: the step writes them in place) are dropped and
    rebuilt from host-side scheduler state, and every in-flight request
    replays its history — greedy decode makes the replay
    bit-identical.  A poison request is found by bisecting the failed
    batch on scratch pools and quarantined
    (:class:`~.errors.RequestQuarantined`).  A failure inside the
    recovery itself (a CUDA error that left the context unusable fails
    the rebuild's allocation again) propagates to the caller.

Observability, as the reference's: ``serve_*`` metrics (queue depth,
running batch, token counters, TTFT and request-latency histograms,
shed / recovery / quarantine / deadline counters) behind
``FLAGS_tpu_metrics``, the flight recorder's request lifecycle events
behind ``FLAGS_tpu_trace`` (``request_timeline``; a deadline expiry
dumps the request's timeline into its incident record), and the live
exporter started from the constructor when ``FLAGS_tpu_metrics_port``
is set.  Each disabled path is one dict lookup.  ``service_model()``
turns the measured step times into the fleet's ``ServiceModel``, and
``prefix_lookup()`` is the router's locality signal
(``serving/router.py``).  The KV pools are recorded as the
``serving.kv_pages`` reservation of ``profiler.xmem`` (its
``xmem_reserved_bytes`` gauge); with FLAGS_tpu_check_nan_inf on, each
step's sampled logits are checked at the numerics sites
``serve.step.logits`` (the target's forward) and ``serve.step.probe``
(a bisection probe), beside the engine's own non-finite check.
"""
from __future__ import annotations

import dataclasses
import logging
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama as _llama
from ..models.convert import params_to
from ..profiler import exporter as _exporter
from ..profiler import metrics as _metrics
from ..profiler import numerics as _numerics
from ..profiler import trace as _trace
from ..profiler import xmem as _xmem
from ..runtime.watchdog import (PhaseTimeout, Watchdog, global_watchdog,
                                record_incident, watchdog_enabled)
from ..testing.chaos import ChaosError, ReplicaKilled, chaos_point
from . import stats as _stats
from .errors import AdmissionRejected, DeadlineExceeded, RequestQuarantined
from .kv_cache import PagedKVCache, _cdiv, kv_bytes_per_token
from .scheduler import (AdmissionGate, Request, RequestState, Scheduler,
                        StepPlan)
from .spec_decode import DraftModel, SpecDecodeConfig, greedy_accept

__all__ = ["LLMEngine", "SLOConfig", "serving_stats", "reset_stats",
           "summary_lines"]

_LOG = logging.getLogger("paddle_tpu_torch.serving")

_STATS = _stats.STATS
serving_stats = _stats.serving_stats
reset_stats = _stats.reset_stats

# the forwards a step can run, counted by kind (``LLMEngine.forwards``):
# the target's step, the draft's mirror of it and its proposals, and the
# bisection probes of a recovery
FORWARD_KINDS = ("target", "mirror", "propose", "probe")


def summary_lines() -> List[str]:
    """The "Serving" summary block (the reference's Profiler section)."""
    s = _STATS
    lines = ["Serving"]
    if not s["engines"]:
        lines.append("  (no LLMEngine instantiated)")
        return lines
    lines.append(
        f"  requests: {int(s['requests_added'])} added  "
        f"{int(s['requests_finished'])} finished  "
        f"{int(s['requests_preempted'])} preempted")
    lines.append(
        f"  steps: {int(s['steps'])}  "
        f"tokens: {int(s['prefill_tokens'])} prefill  "
        f"{int(s['decode_tokens'])} decode  "
        f"peak batch: {int(s['peak_running'])}")
    lines.append(f"  kv pools: {s['pool_bytes'] / 2**20:.1f} MiB")
    if s["prefix_hit_tokens"] or s["spec_proposed"]:
        lines.append(
            f"  reuse: {int(s['prefix_hit_tokens'])} prefix-hit tokens "
            f"({int(s['prefix_evicted_pages'])} pages evicted)  "
            f"spec: {int(s['spec_accepted'])}/{int(s['spec_proposed'])} "
            f"drafts accepted")
    lines.append(
        f"  resilience: {int(s['recoveries'])} recoveries  "
        f"{int(s['quarantined'])} quarantined  "
        f"{int(s['shed'])} shed  "
        f"{int(s['deadline_expired'])} deadline-expired  "
        f"{int(s['cancelled'])} cancelled")
    lines.append(
        f"  replicas: {int(s['failovers'])} failovers  "
        f"{int(s['replicas_dead'])} dead  "
        f"{int(s['drains'])} drains  "
        f"callback errors: {int(s['callback_errors'])}")
    from . import router as _router  # function-local: router imports us
    lines.extend(_router.replica_summary_lines())
    return lines


@dataclasses.dataclass
class SLOConfig:
    """Service-level objectives for one engine.  All in seconds; None
    leaves that objective unset.  ``deadline_s`` is the default
    per-request deadline applied at admission when the caller passes
    none."""

    ttft_p95_s: Optional[float] = None
    latency_p95_s: Optional[float] = None
    deadline_s: Optional[float] = None


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
            if _metrics.enabled():
                _metrics.counter(
                    "serve_callback_errors_total",
                    "User on_token callbacks that raised").inc()


def _kv_dtype(kv_dtype, model_dtype) -> torch.dtype:
    """The pool dtype: None -> the model's, "bf16" / "int8" by name, or
    a torch dtype."""
    if kv_dtype is None:
        return model_dtype
    if isinstance(kv_dtype, str):
        named = {"bf16": torch.bfloat16, "int8": torch.int8}
        if kv_dtype not in named:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             f"(one of {sorted(named)} or a torch dtype)")
        return named[kv_dtype]
    if not isinstance(kv_dtype, torch.dtype):
        raise TypeError(f"kv_dtype must be a name or a torch dtype, got "
                        f"{kv_dtype!r}")
    return kv_dtype


def _sample(logits: torch.Tensor, qlens: torch.Tensor):
    """Argmax at every fed position ([R, Tc] int32; position q_len - 1
    is the sampled token, the earlier ones are what a verify row reads)
    and the max logit of each row's last fed position ([R] f32), which
    the step checks for non-finite values."""
    last = (qlens.long() - 1).clamp(0, logits.shape[1] - 1)
    rows = logits[torch.arange(logits.shape[0], device=logits.device),
                  last]                                      # [R, V]
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.amax(rows, dim=-1))


# A CUDA error such as an illegal address or a device-side assert leaves
# the context unusable: torch raises it as ``torch.AcceleratorError`` (a
# RuntimeError), and every later call on the card fails too.  A probe
# that meets one cannot tell a poison request from a dead card, so it
# re-raises instead of reading as "dirty".
_STICKY = (torch.AcceleratorError,)


class LLMEngine:
    """Continuous-batching serving engine over ``models/llama.py``.

    ``page_size`` tokens per pool page, ``num_pages`` pool pages per
    layer (default: enough for every slot at ``max_model_len``, +1 for
    the reserved null page), ``chunk`` the prefill chunk length (also the
    prefill Tc), ``max_running`` the fixed batch width, ``max_queue`` the
    admission queue bound (default ``8 * max_running``).  Runs on the
    card unless ``device`` names another; with ``cfg.quantized`` "auto"
    (the default) the weights are quantized to int8 at build on CUDA.

    ``kv_dtype`` is the pages' dtype: None means the model's, else
    "bf16", "int8" or a torch dtype.  int8 pages come with f32 scale
    pools [L, nkv, P] (one scale per layer, kv head and page, indexed by
    the same block tables): ``forward_paged`` quantizes on write and
    the attention kernel dequantizes on read.  ``prefix_cache=True``
    turns on shared-prefix KV reuse: admission matches each prompt
    against the radix cache (``serving/prefix_cache.py``) and prefills
    only the uncached tail; a partially matched page is forked
    copy-on-write, scales included.  ``spec=SpecDecodeConfig(...)``
    attaches a draft model: every decode row widens to a 1 + k verify
    row in the Tc = chunk step (``serving/spec_decode.py``).  Outputs
    stay bit-identical to plain greedy decode with either on, over
    float pages.

    ``clock`` is the engine's monotonic time source (injectable for
    tests), ``slo`` carries TTFT/latency targets and the default
    per-request deadline, ``watchdog`` overrides the flag-gated global
    watchdog (``FLAGS_tpu_watchdog``) for the ``serve.step`` phase.
    ``forwards`` counts the forwards run so far by kind
    (``FORWARD_KINDS``).  With ``FLAGS_tpu_metrics_port`` set the
    constructor starts (or attaches to) the live exporter."""

    def __init__(self, cfg, params, *, device=None, max_running: int = 8,
                 chunk: int = 16, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 kv_dtype=None, max_queue: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec: Optional[SpecDecodeConfig] = None,
                 slo: Optional[SLOConfig] = None,
                 watchdog: Optional[Watchdog] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.device = resolve_device(device)
        self.cfg = cfg
        given = params
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

        self._clock = clock
        self.max_queue = int(max_queue if max_queue is not None
                             else 8 * self.max_running)
        self.slo = slo
        self._watchdog = watchdog
        self._gate = AdmissionGate(self.max_queue)
        # per-bucket step wall times (engine clock; each step's device
        # work ends in the device-to-host copy of its sampled tokens)
        self._step_wall_s: Dict[int, List[float]] = {}
        # the same for steps whose every row is a spec verify row (the
        # speculative counterpart of a Tc = 1 decode step)
        self._verify_wall_s: List[float] = []
        self._ttft_s: List[float] = []
        self._latency_s: List[float] = []
        # TTFT/latency decomposition (queue + prefill sums to TTFT by
        # construction, + decode to latency)
        self._queue_s: List[float] = []
        self._prefill_s: List[float] = []
        self._decode_s: List[float] = []
        self.forwards: Dict[str, int] = dict.fromkeys(FORWARD_KINDS, 0)

        self.kv = PagedKVCache(self.num_pages, self.page_size,
                               self.max_blocks)
        self.scheduler = Scheduler(self.kv, max_running=self.max_running,
                                   chunk=self.chunk,
                                   max_model_len=self.max_model_len)

        L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        self._kv_dtype = _kv_dtype(kv_dtype, cfg.dtype)
        self._quant_kv = self._kv_dtype == torch.int8
        self._pool_shape = (L, nkv, self.num_pages, self.page_size, d)
        self._scale_shape = (L, nkv, self.num_pages)
        self._kp = self._vp = self._ks = self._vs = None
        self._alloc_pools()
        self._scale_bytes = (2 * self._ks.numel() * 4 if self._quant_kv
                             else 0)
        self._pool_bytes = (2 * self._kp.numel() * self._kp.element_size()
                            + self._scale_bytes)
        self._requests: Dict[int, Request] = {}
        self._steps = 0
        # rids scheduled in the previous step — the edge detector for
        # per-request "admitted" trace events (incl. re-admissions)
        self._sched_rids: set = set()
        self._prefix_enabled = bool(prefix_cache)
        if self._prefix_enabled:
            self.kv.enable_prefix_cache()
        self._evicted_seen = 0

        self._draft: Optional[DraftModel] = None
        self._spec_k = 0
        if spec is not None:
            if spec.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {spec.cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
            if not 1 <= spec.k < self.chunk:
                raise ValueError(
                    f"spec.k={spec.k} must satisfy 1 <= k < chunk="
                    f"{self.chunk} (the verify chunk 1+k rides the "
                    "prefill bucket)")
            if spec.params is given and spec.cfg == cfg:
                dparams = self.params      # self-draft: the same tensors
            else:
                dparams = params_to(spec.params, self.device)
                if _llama._quantized_mode(spec.cfg, self.device):
                    dparams = _llama.quantize_params(spec.cfg, dparams)
            self._draft = DraftModel(
                spec.cfg, dparams, num_pages=self.num_pages,
                page_size=self.page_size, device=self.device)
            self._spec_k = int(spec.k)
            self.scheduler.spec_k = self._spec_k
        _STATS["engines"] += 1
        _STATS["pool_bytes"] += self._pool_bytes
        _xmem.record_reservation(
            "serving.kv_pages", self._pool_bytes, pages=self.num_pages,
            page_size=self.page_size,
            kv_dtype=str(self._kv_dtype).replace("torch.", ""),
            scale_pool_bytes=self._scale_bytes,
            bytes_per_token=kv_bytes_per_token(
                cfg, torch.tensor([], dtype=self._kv_dtype).element_size()))

        _exporter.maybe_serve("engine", self)

    def _alloc_pools(self) -> None:
        """Fresh pools: zeros, and scales of 1.0 with int8 pages (an
        untouched all-zero page dequantizes to exact zeros).  The old
        pools are dropped first, so a rebuild never holds two sets."""
        self._kp = self._vp = self._ks = self._vs = None
        self._kp = torch.zeros(self._pool_shape, dtype=self._kv_dtype,
                               device=self.device)
        self._vp = torch.zeros(self._pool_shape, dtype=self._kv_dtype,
                               device=self.device)
        if self._quant_kv:
            self._ks = torch.ones(self._scale_shape, dtype=torch.float32,
                                  device=self.device)
            self._vs = torch.ones(self._scale_shape, dtype=torch.float32,
                                  device=self.device)

    # -- request intake --------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int,
                    eos_token_id: Optional[int] = None,
                    on_token: Optional[Callable] = None,
                    deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; returns its id.  ``on_token(rid, token,
        finished)`` streams every generated token from the step that
        produced it (isolated — a raising callback cannot kill the
        engine).  ``deadline_s`` is relative to now on the engine clock;
        the default comes from ``slo.deadline_s``.  Raises
        :class:`AdmissionRejected` (retriable) when the bounded queue is
        shedding."""
        depth = self.scheduler.num_waiting
        if self._gate.check(depth):
            _STATS["shed"] += 1
            if _metrics.enabled():
                _metrics.counter(
                    "serve_shed_total",
                    "Requests rejected by admission control").inc()
            # rid -1: the request was never created, but the shed event
            # still belongs in the flight recorder's serving timeline
            _trace.request_event("shed", -1, t=self._clock(),
                                 queue_depth=depth)
            raise AdmissionRejected(
                f"admission queue at {depth}/{self.max_queue}; "
                f"shedding until it drains below {self.max_queue // 2} "
                f"— retry with backoff")
        if deadline_s is None and self.slo is not None:
            deadline_s = self.slo.deadline_s
        now = self._clock()
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      on_token=(_SafeCallback(on_token)
                                if on_token is not None else None),
                      arrival_s=now,
                      deadline_s=(None if deadline_s is None
                                  else now + float(deadline_s)))
        self.scheduler.add(req)
        self._requests[req.rid] = req
        _trace.request_event("queued", req.rid, t=now,
                             prompt_len=len(req.prompt),
                             max_new_tokens=req.max_new_tokens,
                             deadline_s=req.deadline_s)
        _STATS["requests_added"] += 1
        if _metrics.enabled():
            _metrics.gauge("serve_queue_depth",
                           "Requests waiting for admission").set(
                self.scheduler.num_waiting)
        return req.rid

    def request(self, rid: int) -> Request:
        """The request record (state, output, clock stamps)."""
        return self._requests[rid]

    def output_of(self, rid: int) -> List[int]:
        return list(self._requests[rid].output)

    def state_of(self, rid: int) -> RequestState:
        return self._requests[rid].state

    def error_of(self, rid: int) -> Optional[BaseException]:
        """Terminal error of a FAILED request (DeadlineExceeded,
        RequestQuarantined), else None."""
        return self._requests[rid].error

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
        self.scheduler.remove(req, now_s=self._clock(),
                              state=RequestState.CANCELLED)
        _STATS["cancelled"] += 1
        if _metrics.enabled():
            _metrics.counter("serve_cancelled_total",
                             "Requests cancelled by the caller").inc()
        return True

    # -- the step --------------------------------------------------------
    @staticmethod
    def _batch_arrays(seqs, R: int, Tc: int, Bmax: int, kv,
                      drafts: Optional[Dict[int, List[int]]] = None):
        """Host-side input assembly for one step over ``seqs``.  A spec
        row feeds its one known token followed by the draft's proposals
        (the verify chunk)."""
        tokens = np.zeros((R, Tc), np.int32)
        tbl = np.zeros((R, Bmax), np.int32)
        lens = np.zeros((R,), np.int32)
        qlens = np.zeros((R,), np.int32)
        for s in seqs:
            req = s.request
            if s.spec and drafts is not None:
                row = (req.known[req.fed:req.fed + 1]
                       + drafts[s.slot][:s.q_len - 1])
            else:
                row = req.known[req.fed:req.fed + s.q_len]
            tokens[s.slot, :s.q_len] = row
            tbl[s.slot] = kv.block_row(req.rid)
            lens[s.slot] = s.seq_len
            qlens[s.slot] = s.q_len
        return tokens, tbl, lens, qlens

    def _apply_copies(self, pairs) -> None:
        """Run the COW page forks on the device, in place: each copies
        the page of every layer and kv head and, with int8 pools, its
        dequant scales — on the target pools and, with a draft, the
        draft's (the same page pair, so a donated page carries both
        models' kv)."""
        for src, dst in pairs:
            for pool in (self._kp, self._vp, self._ks, self._vs):
                if pool is not None:
                    pool[:, :, dst] = pool[:, :, src]
            if self._draft is not None:
                self._draft.copy_page(src, dst)

    def _run(self, kind: str, slots, tokens, tbl, lens, qlens, pools
             ) -> np.ndarray:
        """One target forward over ``pools`` (kp, vp, ks, vs; written in
        place); returns the sampled tokens [R, Tc].  The copies to the
        host are the step's sync point, so a kernel fault surfaces here;
        non-finite logits in ``slots`` raise ``FloatingPointError``."""
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (tokens, tbl, lens, qlens)]
        kp, vp, ks, vs = pools
        self.forwards[kind] += 1
        with torch.no_grad():
            logits, _ = _llama.forward_paged(
                self.cfg, self.params, args[0], kp, vp, args[1], args[2],
                args[3], k_scales=ks, v_scales=vs)
            nxt, chk = _sample(logits, args[3])
        nxt = nxt.cpu().numpy()
        chk = chk.cpu().numpy()[slots]
        if _numerics.enabled():
            _numerics.check_array(
                chk, "serve.step.probe" if kind == "probe"
                else "serve.step.logits", action="raise")
        if not np.all(np.isfinite(chk)):
            raise FloatingPointError(
                f"non-finite logits at step {self._steps} in slots "
                f"{[sl for sl, c in zip(slots, chk) if not np.isfinite(c)]}")
        return nxt

    def _wd(self) -> Optional[Watchdog]:
        if self._watchdog is not None:
            return self._watchdog
        if watchdog_enabled():
            return global_watchdog()
        return None

    def _expire_deadlines(self, now: float) -> None:
        active = [r for r in self.scheduler.slots if r is not None]
        active.extend(self.scheduler.waiting)
        for req in active:
            if req.deadline_s is None or now <= req.deadline_s:
                continue
            _trace.request_event("deadline_expired", req.rid, t=now,
                                 overrun_s=now - req.deadline_s)
            self.scheduler.remove(
                req, now_s=now, state=RequestState.FAILED,
                error=DeadlineExceeded(
                    f"request {req.rid} missed its deadline by "
                    f"{now - req.deadline_s:.3f}s "
                    f"({len(req.output)} tokens streamed)"))
            _STATS["deadline_expired"] += 1
            if _trace.enabled():
                # post-mortem: the expired request's full lifecycle
                # rides into the incident buffer
                record_incident(
                    "serve_deadline_expired", rid=int(req.rid),
                    overrun_s=float(now - req.deadline_s),
                    timeline=self.request_timeline(req.rid)[-32:])
            if _metrics.enabled():
                _metrics.counter(
                    "serve_deadline_expired_total",
                    "Requests failed at their deadline").inc()

    def step(self) -> List[int]:
        """One continuous-batching iteration.  Returns the request ids
        that finished at this step boundary (empty when idle, mid-flight,
        or after a recovered step failure)."""
        now = self._clock()
        self._expire_deadlines(now)
        plan = self.scheduler.schedule()
        tracing = _trace.enabled()
        if tracing:
            for req in plan.preempted:
                _trace.request_event("preempted", req.rid, t=now)
        for s in plan.seqs:
            req = s.request
            if tracing and req.rid not in self._sched_rids:
                _trace.request_event(
                    "admitted", req.rid, t=now, slot=s.slot,
                    prefix_hit=req.fed,
                    readmission=req.admitted_s is not None)
            if req.admitted_s is None:
                # first admission only: a replay keeps the original
                # stamp, so queue time stays arrival -> admission
                req.admitted_s = now
        self._sched_rids = {s.request.rid for s in plan.seqs}
        if plan.admission_blocked:
            _STATS["admission_waits"] += 1
            if _metrics.enabled():
                _metrics.counter(
                    "serve_admission_wait_total",
                    "Steps where free slots waited on pool pages").inc()
        # COW forks from this schedule's prefix matches must land on
        # the device before any forward reads (or the allocator
        # recycles) the pages involved
        pairs = self.kv.drain_copies()
        if pairs:
            self._apply_copies(pairs)
        if not plan.seqs:
            return []
        Tc = plan.bucket

        t_fwd = self._clock()
        try:
            with _trace.span("serve/step", step=self._steps,
                             batch=len(plan.seqs), bucket=Tc):
                nxt, drafts = self._guarded_forward(plan, Tc)
        except ReplicaKilled:
            # whole-replica death is not a step-recoverable fault
            raise
        except Exception as exc:  # noqa: BLE001 — classified in _recover
            return self._recover(plan, exc)

        now = self._clock()
        self._step_wall_s.setdefault(Tc, []).append(now - t_fwd)
        if all(s.spec for s in plan.seqs):
            self._verify_wall_s.append(now - t_fwd)
        out: Dict[int, object] = {}
        prefill = decode = 0
        spec_proposed = spec_accepted = 0
        for s in plan.seqs:
            if s.spec:
                row = [int(t) for t in nxt[s.slot, :s.q_len]]
                emitted = greedy_accept(drafts[s.slot], row)
                out[s.slot] = emitted
                spec_proposed += s.spec
                spec_accepted += len(emitted) - 1
                decode += len(emitted)
                if tracing:
                    _trace.request_event(
                        "spec", s.request.rid, t=now, proposed=s.spec,
                        accepted=len(emitted) - 1)
            elif s.produces:
                out[s.slot] = int(nxt[s.slot, s.q_len - 1])
                if s.q_len == 1:
                    decode += 1
                    if tracing:
                        _trace.request_event("decode", s.request.rid,
                                             t=now, tokens=1)
                else:
                    prefill += s.q_len
                    if tracing:
                        _trace.request_event(
                            "prefill", s.request.rid, t=now,
                            tokens=s.q_len, last_chunk=True)
            else:
                prefill += s.q_len
                if tracing:
                    _trace.request_event(
                        "prefill", s.request.rid, t=now,
                        tokens=s.q_len, last_chunk=False)
        finished = self.scheduler.apply(plan, out, now_s=now)
        self._steps += 1

        _STATS["steps"] += 1
        _STATS["prefill_tokens"] += prefill
        _STATS["decode_tokens"] += decode
        _STATS["requests_preempted"] += len(plan.preempted)
        _STATS["requests_finished"] += len(finished)
        _STATS["peak_running"] = max(_STATS["peak_running"],
                                     len(plan.seqs))
        _STATS["prefix_hit_tokens"] += plan.prefix_hit_tokens
        _STATS["spec_proposed"] += spec_proposed
        _STATS["spec_accepted"] += spec_accepted
        if self._prefix_enabled:
            ev = self.kv.prefix.stats.evicted_pages
            _STATS["prefix_evicted_pages"] += ev - self._evicted_seen
            self._evicted_seen = ev
        for s in plan.seqs:
            r = s.request
            if r.first_token_s is not None and r.first_token_s == now:
                self._ttft_s.append(now - r.arrival_s)
                if r.admitted_s is not None:
                    self._queue_s.append(r.admitted_s - r.arrival_s)
                    self._prefill_s.append(now - r.admitted_s)
        for r in finished:
            self._latency_s.append(now - r.arrival_s)
            if r.first_token_s is not None:
                self._decode_s.append(now - r.first_token_s)
        if _metrics.enabled():
            self._step_metrics(plan, finished, now, prefill, decode,
                               spec_proposed, spec_accepted)
        return [r.rid for r in finished]

    def _step_metrics(self, plan: StepPlan, finished: List[Request],
                      now: float, prefill: int, decode: int,
                      spec_proposed: int, spec_accepted: int) -> None:
        """The step's ``serve_*`` gauges, counters and histograms, under
        the reference's names (only called with metrics on)."""
        _metrics.gauge("serve_queue_depth",
                       "Requests waiting for admission").set(
            self.scheduler.num_waiting)
        _metrics.gauge("serve_running_batch",
                       "Requests in the running batch").set(
            self.scheduler.num_running + len(finished))
        _metrics.counter("serve_prefill_tokens_total",
                         "Prompt tokens fed to the model").inc(prefill)
        _metrics.counter("serve_decode_tokens_total",
                         "Decode tokens generated").inc(decode)
        if plan.preempted:
            _metrics.counter(
                "serve_preemptions_total",
                "Requests preempted for pool pressure").inc(
                len(plan.preempted))
        if plan.prefix_hit_tokens:
            _metrics.counter(
                "serve_prefix_hit_tokens_total",
                "Prompt tokens served from the prefix cache").inc(
                plan.prefix_hit_tokens)
        if spec_proposed:
            _metrics.counter(
                "serve_spec_proposed_total",
                "Draft tokens proposed for verification").inc(
                spec_proposed)
            _metrics.counter(
                "serve_spec_accepted_total",
                "Draft tokens accepted by the target").inc(spec_accepted)
        for s in plan.seqs:
            r = s.request
            if r.first_token_s is not None and r.first_token_s == now:
                _metrics.histogram(
                    "serve_ttft_seconds",
                    "Time to first token").observe(now - r.arrival_s)
        for r in finished:
            _metrics.histogram(
                "serve_request_latency_seconds",
                "Request arrival to completion").observe(
                now - r.arrival_s)

    def _guarded_forward(self, plan: StepPlan, Tc: int):
        """The step's device work under the serve.step watchdog phase
        and chaos point: the draft's proposals, the target's (verify)
        forward, the draft's mirror of it.  Returns the sampled tokens
        [R, Tc] and the drafts (slot -> proposals, or None)."""
        R = self.max_running
        wd = self._wd()
        if wd is not None:
            wd.begin("serve.step")
        try:
            drafts: Optional[Dict[int, List[int]]] = None
            if self._draft is not None:
                spec_rows = [
                    (s.slot, s.request.known[s.request.fed],
                     s.request.fed, self.kv.block_row(s.request.rid))
                    for s in plan.seqs if s.spec]
                if spec_rows:
                    self.forwards["propose"] += self._spec_k
                    drafts = self._draft.propose(
                        spec_rows, self._spec_k, R, self.max_blocks)
            tokens, tbl, lens, qlens = self._batch_arrays(
                plan.seqs, R, Tc, self.max_blocks, self.kv, drafts)
            chaos_point("serve.step", step=self._steps,
                        rids=[s.request.rid for s in plan.seqs],
                        pool=self.kv.allocator, engine=self)
            nxt = self._run("target", [s.slot for s in plan.seqs], tokens,
                            tbl, lens, qlens,
                            (self._kp, self._vp, self._ks, self._vs))
            if self._draft is not None:
                # mirror: the draft ingests the exact same feed, so its
                # kv tracks the target's fed counter in lockstep
                self.forwards["mirror"] += 1
                self._draft.forward(tokens, tbl, lens, qlens)
            if wd is not None:
                # synchronous expiry: a call that came back past its
                # deadline is still a hang (a hung kernel cannot be
                # interrupted from the host)
                for exc in wd.poll(raise_on_expire=False):
                    if exc.phase == "serve.step":
                        raise exc
            return nxt, drafts
        finally:
            if wd is not None:
                wd.end("serve.step")

    # -- crash recovery --------------------------------------------------
    @staticmethod
    def _classify(exc: BaseException) -> str:
        if isinstance(exc, PhaseTimeout):
            return "hang"
        if isinstance(exc, FloatingPointError):
            return "non_finite"
        if isinstance(exc, ChaosError):
            return "injected"
        if isinstance(exc, (RuntimeError, OSError)):
            # torch.AcceleratorError (a CUDA error) is a RuntimeError
            return "device_error"
        return "unknown"

    def _rebuild(self) -> List[Request]:
        """Drop the (half-written) pools and all host page state; rebuild
        both from scratch and demote every running request to the front
        of the queue with fed=0 — the fed/known path then replays prompt
        + generated tokens, bit-identical under greedy decode.  The
        prefix trie is rebuilt empty (its pages lived in the dropped
        pools) and the draft pools reset with it."""
        self.kv = PagedKVCache(self.num_pages, self.page_size,
                               self.max_blocks)
        if self._prefix_enabled:
            self.kv.enable_prefix_cache()
            self._evicted_seen = 0
        self.scheduler.kv = self.kv
        self._alloc_pools()
        if self._draft is not None:
            self._draft.reset()
        demoted = self.scheduler.reset_running()
        self.scheduler.requeue_front(demoted)
        self._sched_rids.clear()
        if _trace.enabled():
            now = self._clock()
            for req in demoted:
                _trace.request_event("replay", req.rid, t=now,
                                     replayed_tokens=req.num_known)
        return demoted

    def _probe(self, group: List[Request]) -> bool:
        """Replay ``group``'s first chunks on scratch pools of their own,
        just large enough for them (the live pools may fill the card);
        True when the step is clean.  Fires the serve.step chaos point
        with the group's rids, so a ``rid=``-scoped rule keeps blaming
        its target and bisection converges on it."""
        qs = [min(self.chunk, req.num_known) for req in group]
        P = 1 + sum(_cdiv(q, self.page_size) for q in qs)
        kv = PagedKVCache(P, self.page_size, self.max_blocks)
        seqs = []
        for slot, (req, q) in enumerate(zip(group, qs)):
            kv.grow(req.rid, q)
            seqs.append(_ProbeSeq(req, slot, q))
        Tc = self.chunk if any(s.q_len > 1 for s in seqs) else 1
        tokens, tbl, lens, qlens = self._batch_arrays(
            seqs, self.max_running, Tc, self.max_blocks, kv)
        try:
            chaos_point("serve.step", step=self._steps,
                        rids=[r.rid for r in group],
                        pool=kv.allocator, engine=self, probe=True)
            L, nkv, _, page, d = self._pool_shape
            pools = tuple(torch.zeros((L, nkv, P, page, d),
                                      dtype=self._kv_dtype,
                                      device=self.device) for _ in range(2))
            pools += tuple(torch.ones((L, nkv, P), dtype=torch.float32,
                                      device=self.device)
                           if self._quant_kv else None for _ in range(2))
            self._run("probe", [s.slot for s in seqs], tokens, tbl, lens,
                      qlens, pools)
            return True
        except _STICKY:
            raise
        except Exception:  # noqa: BLE001 — a dirty probe IS the signal
            return False

    def _bisect(self, suspects: List[Request]) -> Optional[Request]:
        """Binary-search the failed batch for a single poison request
        on scratch pools (at most ``1 + 2*ceil(log2 R)`` probes).  None
        means the failure did not reproduce in isolation — transient,
        everyone replays."""
        group = list(suspects)
        if not group or self._probe(group):
            return None
        while len(group) > 1:
            mid = len(group) // 2
            if not self._probe(group[:mid]):
                group = group[:mid]
            elif not self._probe(group[mid:]):
                group = group[mid:]
            else:
                return None  # only fails in combination — transient
        return group[0]

    def _recover(self, plan: StepPlan, exc: Exception) -> List[int]:
        """A failed, hung or poisoned step: classify, rebuild the pools
        from host-side state, quarantine a bisected culprit, replay the
        rest.  Always returns [] — no request finishes at a failed step
        boundary.  Whatever raises in here propagates."""
        failure = self._classify(exc)
        # the traceback's frames hold the failed step's tensors, its
        # pools among them: free them, so the rebuild never holds two
        # sets of pools
        traceback.clear_frames(exc.__traceback__)
        suspects = [s.request for s in plan.seqs]
        self._rebuild()
        culprit = None
        if failure != "hang":
            # probing a genuinely hung fault would hang recovery too;
            # hangs replay wholesale instead
            culprit = self._bisect(suspects)
        _trace.event("serve/recovery", kind="engine", failure=failure,
                     step=int(self._steps), batch=len(suspects))
        if culprit is not None:
            _trace.request_event("quarantine", culprit.rid,
                                 t=self._clock(), failure=failure)
            self.scheduler.remove(
                culprit, now_s=self._clock(),
                state=RequestState.FAILED,
                error=RequestQuarantined(
                    f"request {culprit.rid} quarantined: bisection "
                    f"blamed it for a {failure} step failure ({exc})"))
            _STATS["quarantined"] += 1
            if _metrics.enabled():
                _metrics.counter(
                    "serve_quarantined_total",
                    "Requests quarantined by step-failure "
                    "bisection").inc()
        _STATS["recoveries"] += 1
        record_incident(
            "serve_step_failure", failure=failure, step=int(self._steps),
            batch=len(suspects),
            culprit=(None if culprit is None else int(culprit.rid)),
            replayed=len(suspects) - (culprit is not None),
            error=str(exc)[:200])
        if _metrics.enabled():
            _metrics.counter(
                "serve_recoveries_total",
                "Engine step failures recovered via pool-rebuild "
                "replay", failure=failure).inc()
        _LOG.warning(
            "serve.step failure (%s) at step %d: rebuilt pools, "
            "replaying %d request(s)%s", failure, self._steps,
            len(suspects) - (culprit is not None),
            "" if culprit is None
            else f", quarantined request {culprit.rid}")
        return []

    # -- SLO reporting ----------------------------------------------------
    def slo_report(self) -> Dict[str, Optional[float]]:
        """Observed TTFT/latency p95 against the configured SLOs; the
        ``*_ok`` entries are None when no target is set.  ``breakdown``
        decomposes where the time went: per-request queue (arrival ->
        first admission) and prefill (admission -> first token) sum to
        that request's TTFT, and decode (first token -> finish) extends
        the sum to its full latency."""

        def _p95(xs):
            return float(np.percentile(xs, 95)) if xs else None

        ttft, lat = _p95(self._ttft_s), _p95(self._latency_s)
        slo = self.slo or SLOConfig()
        rep: Dict[str, Optional[float]] = {
            "ttft_p95_s": ttft, "latency_p95_s": lat,
            "ttft_slo_s": slo.ttft_p95_s,
            "latency_slo_s": slo.latency_p95_s,
            "ttft_ok": None, "latency_ok": None,
        }
        if slo.ttft_p95_s is not None and ttft is not None:
            rep["ttft_ok"] = ttft <= slo.ttft_p95_s
        if slo.latency_p95_s is not None and lat is not None:
            rep["latency_ok"] = lat <= slo.latency_p95_s
        rep["breakdown"] = {
            "queue_p95_s": _p95(self._queue_s),
            "prefill_p95_s": _p95(self._prefill_s),
            "decode_p95_s": _p95(self._decode_s),
            "queue_mean_s": (float(np.mean(self._queue_s))
                             if self._queue_s else None),
            "prefill_mean_s": (float(np.mean(self._prefill_s))
                               if self._prefill_s else None),
            "decode_mean_s": (float(np.mean(self._decode_s))
                              if self._decode_s else None),
            "samples": len(self._queue_s),
        }
        return rep

    def service_model(self):
        """Measured per-replica service model for fleet planning
        (:class:`~paddle_tpu_torch.serving.autoscale.ServiceModel`):
        the median step wall time per bucket (Tc = 1, Tc = chunk) on the
        engine clock — the median leaves out one-off first-call steps —
        plus this engine's capacity knobs.  With no step of a bucket
        measured, that bucket keeps the uncalibrated placeholder."""
        from .autoscale import ServiceModel
        return ServiceModel.from_step_samples(
            self._step_wall_s, max_running=self.max_running,
            chunk=self.chunk, page_size=self.page_size,
            num_pages=self.num_pages, max_model_len=self.max_model_len,
            max_queue=self.max_queue)

    def request_timeline(self, rid: int) -> List[dict]:
        """Every flight-recorder event for one request (requires
        ``FLAGS_tpu_trace``; empty list otherwise) — the post-mortem
        view dumped into the incident buffer on deadline expiry."""
        return _trace.request_timeline(rid)

    def prefix_lookup(self, prompt) -> int:
        """How many tokens of ``prompt`` this engine's prefix cache
        would serve without prefill (0 when the cache is off).  Side-
        effect free — the router's locality-placement signal."""
        if self.kv.prefix is None:
            return 0
        return self.kv.prefix.peek([int(t) for t in prompt])

    def clear_samples(self) -> None:
        """Drop the step-time and SLO samples taken so far (a bench's
        warm-up)."""
        for xs in (self._ttft_s, self._latency_s, self._queue_s,
                   self._prefill_s, self._decode_s, self._verify_wall_s):
            xs.clear()
        self._step_wall_s.clear()

    # -- convenience -----------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until all queued/running work completes (or max_steps);
        returns rid -> generated tokens for every request that left the
        WAITING state (including cancelled and failed partials)."""
        steps = 0
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return {rid: list(r.output) for rid, r in self._requests.items()
                if r.state is not RequestState.WAITING}

    def shutdown(self) -> None:
        """Drop the pools (the draft's too)."""
        _STATS["pool_bytes"] -= self._pool_bytes
        _xmem.record_reservation("serving.kv_pages", 0)
        self._kp = self._vp = self._ks = self._vs = None
        if self._draft is not None:
            self._draft.shutdown()


@dataclasses.dataclass
class _ProbeSeq:
    """Minimal ScheduledSeq stand-in for ``_batch_arrays`` during
    bisection probes (fed is always 0 — probes replay first chunks)."""

    request: Request
    slot: int
    q_len: int
    spec: int = 0

    @property
    def seq_len(self) -> int:
        return self.q_len
