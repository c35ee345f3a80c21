"""Serving bench of the port: continuous-batching throughput on one card
(the counterpart of the repository's ``bench_serve.py``).  Run from the
repository root:

    python -m paddle_tpu_torch.bench_serve                   # on the card
    python -m paddle_tpu_torch.bench_serve --kv-dtype int8   # int8 KV pages
    python -m paddle_tpu_torch.bench_serve --workload shared-prefix
    python -m paddle_tpu_torch.bench_serve --device cpu      # CPU shape
    python -m paddle_tpu_torch.bench_serve --trace-out DIR   # + sidecar

It drives ``serving.LLMEngine`` with ``bench_serve.py``'s staggered
open-loop traffic (requests keep arriving while the batch is in flight,
so continuous admission and the mixed prefill + decode path both run)
and prints ONE line::

    BENCH_SERVE {"metric": "serve_tokens_per_sec_chip", ...}

with output tokens/s, TTFT and request-latency p50/p95 (exact
percentiles over the requests' clock stamps, the reference bench's own
fallback), the step counts, the forwards by kind, the ``kv`` block, the
``resilience`` block (shed, recoveries, quarantined, deadline-expired
counts of the measured run, and its ``slo`` verdicts), the ``fleet``
block (the engine's ``service_model()`` calibrated from this run's step
times by bucket, its capacity in requests/s and ``replicas_for`` at the
offered rate) and, for the shared-prefix workload, the ``reuse`` block.
It exits non-zero, with
an ``error`` in the line, when the run failed.

The model is the ``llama7b`` preset on the card (int8 weights, as the
engine quantizes on CUDA) and ``llama-debug`` on the CPU (the reference
bench's default, its CPU shape).  Weights are random from seed 0.

Traffic knobs, as ``bench_serve.py`` reads them (environment,
``PADDLE_TPU_BENCH_SERVE_`` + name): REQUESTS (16), PROMPT (max prompt
length, 24), NEW (tokens per request, 16), MAX_RUNNING (8), CHUNK (8),
PAGE (16), PAGES (pool pages; default: every slot at max_model_len),
MAX_QUEUE (8 x MAX_RUNNING), SEED (0, shaped presets), HORIZON_S (60,
shaped presets), SYS_PROMPTS (2, shared-prefix), SPEC_K (3,
shared-prefix; 0 turns speculation off), TTFT_SLO_MS and LAT_SLO_MS
(the SLO targets the ``slo`` block judges; unset by default).  Prompts
come from ``RandomState(0)``; half
the requests arrive up front and one more every other step, or, for the
shaped presets (diurnal, bursty, flash-crowd), on
``workloads.step_schedule``'s steps.  One warm-up request runs before
the clock (one per system prompt for shared-prefix).

``--workload shared-prefix`` turns on the reference's reuse stack: the
prefix cache and self-draft speculative decoding (the draft IS the
target, on the same weights, so acceptance isolates the machinery from
draft quality) with k = SPEC_K.  Its ``reuse`` block carries the
prefix hit rate and the spec acceptance rate.

``--trace-out DIR`` (or TRACE_OUT) turns on the flight recorder
(``FLAGS_tpu_trace``) for the measured run and writes its JSONL sidecar
(``trace_rank0.jsonl``) into DIR; the line carries its path as
``trace_sidecar``; ``tools/trace_report.py`` reads it.  With
``FLAGS_tpu_metrics_port`` set (``paddle_tpu_torch.flags`` or the
environment) the engine starts the live exporter and the line carries
the bound ``metrics_port``.

Not carried over from ``bench_serve.py``: the ledger block
(``--ledger-out``), which waits for the port of ``profiler/ledger.py``
(ROADMAP A item 5); no code of the port writes the perf ledger.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import flags as _flags
from .bench import gpu_line
from .device import resolve_device
from .models import llama
from .ops import int8_matmul as i8
from .ops import ragged_paged_attention as rpa
from .profiler import exporter as _exporter
from .profiler import trace as _trace
from . import serving
from .serving import autoscale as _autoscale
from .serving import workloads as _workloads

_ENV = "PADDLE_TPU_BENCH_SERVE_"
KNOBS = dict(REQUESTS=16, PROMPT=24, NEW=16, MAX_RUNNING=8, CHUNK=8,
             PAGE=16, SYS_PROMPTS=2, SEED=0, SPEC_K=3)
KV_DTYPES = ("bf16", "int8")
SHAPED = ("diurnal", "bursty", "flash-crowd")


def knobs(env=None) -> Dict[str, Optional[float]]:
    """The traffic knobs from ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    out: Dict[str, Optional[float]] = {
        k: int(env.get(_ENV + k, v)) for k, v in KNOBS.items()}
    out["MAX_QUEUE"] = int(env.get(_ENV + "MAX_QUEUE",
                                   8 * out["MAX_RUNNING"]))
    pages = env.get(_ENV + "PAGES")
    out["PAGES"] = int(pages) if pages else None
    out["HORIZON_S"] = float(env.get(_ENV + "HORIZON_S", "60"))
    for slo in ("TTFT_SLO_MS", "LAT_SLO_MS"):
        v = env.get(_ENV + slo)
        out[slo] = float(v) if v else None
    return out


def kernel_launches() -> Dict[str, int]:
    """The serving kernels' launch counts (since their last reset)."""
    return {"int8_matmul": i8.int8_matmul.launches,
            "ragged_paged_attention": rpa.ragged_paged_attention.launches,
            "ragged_paged_attention_quant":
                rpa.ragged_paged_attention.quant_launches}


def reset_kernel_launches() -> None:
    i8.int8_matmul.launches = 0
    rpa.ragged_paged_attention.launches = 0
    rpa.ragged_paged_attention.quant_launches = 0


def prompts_for(workload: str, k: Dict, vocab: int):
    """(prompts, warm-up prompts, arrivals or None) as ``bench_serve.py``
    draws them."""
    n_req, max_prompt = k["REQUESTS"], k["PROMPT"]
    rng = np.random.RandomState(0)
    if workload in SHAPED:
        arrivals = _workloads.generate(
            workload, n_req, seed=k["SEED"], horizon_s=k["HORIZON_S"],
            prompt_len=max_prompt, max_new_tokens=k["NEW"], vocab=vocab)
        prompts = [list(a.prompt) for a in arrivals]
        return prompts, [prompts[0]], arrivals
    if workload == "shared-prefix":
        # N requests over M system prompts: the shared head is most of
        # the prompt, the tail per request
        n_sys = k["SYS_PROMPTS"]
        sys_len = max(max_prompt * 3 // 4, 2)
        sys_prompts = [list(rng.randint(0, vocab, sys_len))
                       for _ in range(n_sys)]
        prompts = [
            sys_prompts[i % n_sys]
            + list(rng.randint(0, vocab, rng.randint(
                1, max(max_prompt - sys_len, 1) + 1)))
            for i in range(n_req)]
        return prompts, sys_prompts, None
    prompts = [list(rng.randint(0, vocab, rng.randint(2, max_prompt + 1)))
               for _ in range(n_req)]
    return prompts, [prompts[0]], None


@dataclasses.dataclass
class ServeRun:
    """What one run leaves: the ``BENCH_SERVE`` fields, the engine and
    the measured requests' ids (in submission order)."""

    result: dict
    engine: "serving.LLMEngine"
    rids: List[int]


def _pct(vals, q):
    return float(np.percentile(vals, q)) if vals else 0.0


def serve(device=None, *, kv_dtype: str = "bf16",
          workload: str = "uniform", params=None,
          trace_out: Optional[str] = None) -> ServeRun:
    """One bench run.  ``params`` (the preset's, already on the device,
    int8 or not) skips the weight build, so a caller can serve several
    runs from one set of weights.  ``trace_out`` (default: the TRACE_OUT
    knob) names the directory of the run's trace sidecar; it turns
    ``FLAGS_tpu_trace`` on for the run."""
    if trace_out is None:
        trace_out = os.environ.get(_ENV + "TRACE_OUT") or None
    tracing = _flags.flag("FLAGS_tpu_trace")
    if trace_out:
        _flags.set_flags({"FLAGS_tpu_trace": True})
    try:
        return _serve(device, kv_dtype, workload, params, trace_out)
    finally:
        _flags.set_flags({"FLAGS_tpu_trace": tracing})


def _serve(device, kv_dtype, workload, params, trace_out) -> ServeRun:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    _workloads.validate(workload)
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv dtype {kv_dtype!r} "
                         f"({' | '.join(KV_DTYPES)})")
    k = knobs()
    preset = "llama7b" if on_card else "llama-debug"
    cfg = llama.preset(preset)
    if params is None:
        params = llama.init_params(cfg, 0, device=dev)
    n_new, chunk, page = k["NEW"], k["CHUNK"], k["PAGE"]
    shared = workload == "shared-prefix"
    max_model_len = min(cfg.max_position_embeddings,
                        k["PROMPT"] + n_new + chunk)
    spec_k = k["SPEC_K"] if shared else 0
    slo = serving.SLOConfig(
        ttft_p95_s=k["TTFT_SLO_MS"] / 1e3 if k["TTFT_SLO_MS"] else None,
        latency_p95_s=k["LAT_SLO_MS"] / 1e3 if k["LAT_SLO_MS"] else None)
    eng = serving.LLMEngine(
        cfg, params, device=dev, max_running=k["MAX_RUNNING"], chunk=chunk,
        page_size=page, num_pages=k["PAGES"], max_model_len=max_model_len,
        kv_dtype=None if kv_dtype == "bf16" else kv_dtype,
        max_queue=k["MAX_QUEUE"], prefix_cache=shared, slo=slo,
        # self-draft on the engine's own weights (the same object)
        spec=(serving.SpecDecodeConfig(cfg, params, k=spec_k)
              if spec_k else None))
    del params      # the engine holds its own (on CUDA: int8) weights
    prompts, warm, arrivals = prompts_for(workload, k, cfg.vocab_size)

    # warm-up before the clock: first-call costs; for shared-prefix one
    # request per system prompt, so the trie holds every shared head
    for p in warm:
        eng.add_request(p, 2)
    eng.run()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    eng.clear_samples()
    if trace_out:
        _trace.clear()      # the measured run's lifecycle events only
    base = serving.serving_stats()
    fwd_base = dict(eng.forwards)

    rids: List[int] = []
    shed = 0

    def submit(p):
        nonlocal shed
        try:
            rids.append(eng.add_request(p, n_new))
        except serving.AdmissionRejected:
            shed += 1

    t_start = time.monotonic()
    steps = 0
    if arrivals is not None:
        # the preset's own timeline, mapped onto engine steps
        sched = _workloads.step_schedule(arrivals, max(2 * len(prompts), 1))
        last = max(sched) if sched else 0
        while eng.has_work() or steps <= last:
            for a in sched.get(steps, ()):
                submit(list(a.prompt))
            eng.step()
            steps += 1
            if steps > 100000:
                raise RuntimeError("serve loop did not converge")
    else:
        for p in prompts[:len(prompts) // 2]:
            submit(p)
        pending = list(prompts[len(prompts) // 2:])
        while eng.has_work() or pending:
            if pending and steps % 2 == 1:
                submit(pending.pop(0))
            eng.step()
            steps += 1
            if steps > 100000:
                raise RuntimeError("serve loop did not converge")
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t_start
    now = serving.serving_stats()
    res = {key: int(now[key] - base[key])
           for key in ("shed", "admission_waits", "recoveries",
                       "quarantined", "deadline_expired", "callback_errors")}

    reqs = [eng.request(r) for r in rids]
    done = [r for r in reqs if r.state is serving.RequestState.FINISHED]
    if len(done) != len(reqs) and not (res["quarantined"]
                                       or res["deadline_expired"]):
        # without a terminal resilience event every admitted request
        # finishes: shedding only ever rejects at the front door
        raise RuntimeError(f"{len(reqs) - len(done)} admitted requests "
                           f"did not finish")
    short = [r.rid for r in done if len(r.output) != n_new]
    if short:
        raise RuntimeError(f"requests {short} finished short of {n_new} "
                           f"tokens")
    tokens = sum(len(r.output) for r in done)
    ttft = [r.first_token_s - r.arrival_s for r in done]
    lat = [r.finish_s - r.arrival_s for r in done]
    hit = int(now["prefix_hit_tokens"] - base["prefix_hit_tokens"])
    proposed = int(now["spec_proposed"] - base["spec_proposed"])
    accepted = int(now["spec_accepted"] - base["spec_accepted"])
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    dec = eng._step_wall_s.get(1, [])
    pre = eng._step_wall_s.get(chunk, [])
    ver = eng._verify_wall_s
    forwards = {kind: n - fwd_base[kind] for kind, n in eng.forwards.items()}

    def ms(v):
        return None if v is None else 1e3 * v

    # the fleet block: the service model calibrated from this run's step
    # times by bucket, and the capacity arithmetic the autoscaler plans
    # with (its uncalibrated placeholders never stand for a measurement:
    # ``calibrated`` says which)
    sm = eng.service_model()
    mean_prompt = (prompt_tokens // len(reqs)) if reqs else k["PROMPT"]
    offered_rps = (len(rids) + shed) / wall if wall else 0.0
    fleet = {
        "calibrated": sm.calibrated,
        "prefill_chunk_ms": ms(sm.prefill_chunk_s),
        "decode_step_ms": ms(sm.decode_step_s),
        "prefill_steps_measured": len(pre),
        "decode_steps_measured": len(dec),
        "concurrency": sm.concurrency,
        "capacity_rps_per_chip": sm.capacity_rps(mean_prompt, n_new),
        "offered_rps": offered_rps,
        "min_chips_for_offered": _autoscale.replicas_for(
            sm, offered_rps, prompt_len=max(mean_prompt, 1),
            new_tokens=n_new),
    }

    rep = eng.slo_report()
    res["slo"] = {
        "ttft_p95_ms": ms(rep["ttft_p95_s"]),
        "ttft_slo_ms": ms(rep["ttft_slo_s"]),
        "ttft_ok": rep["ttft_ok"],
        "latency_p95_ms": ms(rep["latency_p95_s"]),
        "latency_slo_ms": ms(rep["latency_slo_s"]),
        "latency_ok": rep["latency_ok"],
    }

    result = {
        "metric": "serve_tokens_per_sec_chip",
        "value": tokens / wall,
        "unit": "tokens/s/chip",
        "ttft_p50_ms": ms(_pct(ttft, 50)), "ttft_p95_ms": ms(_pct(ttft, 95)),
        "latency_p50_ms": ms(_pct(lat, 50)),
        "latency_p95_ms": ms(_pct(lat, 95)),
        "requests": len(rids), "shed_submits": shed,
        "max_queue": k["MAX_QUEUE"], "workload": workload,
        "tokens": tokens, "steps": steps, "wall_seconds": wall,
        # measured-run counts (the warm-up is left out)
        "prefill_tokens": int(now["prefill_tokens"] - base["prefill_tokens"]),
        "decode_tokens": int(now["decode_tokens"] - base["decode_tokens"]),
        "preemptions": int(now["requests_preempted"]
                           - base["requests_preempted"]),
        "max_running": k["MAX_RUNNING"], "chunk": chunk, "page_size": page,
        "prompt_len_max": k["PROMPT"], "new_tokens": n_new,
        "decode_step_ms": ms(float(np.mean(dec))) if dec else None,
        "prefill_step_ms": ms(float(np.mean(pre))) if pre else None,
        "decode_steps": len(dec), "prefill_steps": len(pre),
        # steps whose every row verifies drafts (speculation's decode)
        "verify_step_ms": ms(float(np.mean(ver))) if ver else None,
        "verify_steps": len(ver),
        "forwards": forwards,
        "forwards_per_step": sum(forwards.values()) / steps if steps else 0,
        "resilience": res,
        "fleet": fleet,
        "kv": {
            "dtype": kv_dtype,
            "pages": int(eng.num_pages),
            "pool_bytes": int(eng._pool_bytes),
            "scale_pool_bytes": int(eng._scale_bytes),
            "max_concurrent_predicted":
                (eng.num_pages - 1) // eng.max_blocks,
        },
        "preset": preset,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "chips": 1,
    }
    if shared:
        result["reuse"] = {
            "prefix_cache": True,
            "prefix_hit_tokens": hit,
            "prompt_tokens": prompt_tokens,
            "prefix_hit_rate": hit / prompt_tokens if prompt_tokens else 0.0,
            "prefill_tokens_saved": hit,
            "prefix_evicted_pages": int(now["prefix_evicted_pages"]
                                        - base["prefix_evicted_pages"]),
            "spec_k": spec_k,
            "spec_proposed": proposed,
            "spec_accepted": accepted,
            "spec_acceptance_rate": accepted / proposed if proposed else 0.0,
            "draft_pool_bytes": (eng._draft.pool_bytes if eng._draft
                                 else 0),
        }
    if trace_out:
        os.makedirs(trace_out, exist_ok=True)
        result["trace_sidecar"] = _trace.write_sidecar(
            _trace.sidecar_path(trace_out),
            extra={"bench": "serve", "workload": workload,
                   "requests": len(rids)})
    exp = _exporter.active()
    if exp is not None:
        result["metrics_port"] = exp.port
    if on_card:
        result["gpu"] = gpu_line()
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return ServeRun(result=result, engine=eng, rids=rids)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' serves "
                         "llama-debug with the plain versions)")
    ap.add_argument("--kv-dtype", default="bf16", choices=KV_DTYPES)
    ap.add_argument("--workload", default="uniform",
                    help=" | ".join(_workloads.PRESETS))
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="write the measured run's trace sidecar into DIR")
    args = ap.parse_args(argv)
    try:
        result = serve(args.device, kv_dtype=args.kv_dtype,
                       workload=args.workload,
                       trace_out=args.trace_out).result
        ok = True
    except BaseException as exc:  # noqa: BLE001 - the line must print
        result = {"metric": "serve_tokens_per_sec_chip", "value": None,
                  "unit": "tokens/s/chip",
                  "error": f"{type(exc).__name__}: {exc}"[-2000:]}
        ok = False
        if not isinstance(exc, Exception):
            print("BENCH_SERVE " + json.dumps(result), flush=True)
            raise
    print("BENCH_SERVE " + json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
