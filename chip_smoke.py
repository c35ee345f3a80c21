#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/ops/csrc``
with nvcc (one nvcc per source, started together), holds each kernel
against its plain PyTorch version at its main path's shapes and times
both (plus one PyTorch library call for the same function as a
yardstick the port never calls), then drives the two main paths.  The
int8 matmul is held bit for bit and timed at every llama7b shape for a
decode step (M = 8), the default cell's prefill chunk (M = 64) and the
long-context cell's (M = 512), beside ``torch._int_mm`` on the weights
as stored and K-contiguous, and its two regimes side by side where
both apply (M = 8, 16).

- serving: a small model's serving step on the card against the CPU
  (float32 and int8 KV pages); a small float32 model's streams served
  four ways (spec off, self-draft speculation, speculation with the
  prefix cache, and that under an injected step failure) on the card
  and on the CPU, all equal token for token; the same model's streams
  behind a router of two replicas on the card, one killed mid-decode,
  equal to one uninterrupted engine's on the CPU (float32 and int8
  pages); then
  ``paddle_tpu_torch.bench_serve``'s measuring function four times at
  the full width and depth of the ``llama7b`` preset (random weights
  from a seed, int8 weights built once): bf16 KV pages, int8 KV pages,
  and int8 pages under the shared-prefix workload with the prefix cache
  and self-draft speculation at k = 3, and the same with speculation
  off; every launch counted through the int8 matmul and the two ragged
  paged attention kernels (bf16 pools, int8 pools) and held to the
  engine's forwards by kind (target, the draft's mirror and proposals,
  bisection probes), the KV pool bytes held to their formula and the
  spec run's peak memory to the spec-off run's plus the draft's pools;
  crash recovery on the same weights (int8 KV, prefix, speculation): a
  transient step failure, a request-scoped poison (quarantined by
  bisection) and a step past its watchdog deadline, every request
  accounted for; the serving stack (``fleet_phase``): two replicas of
  the shared-prefix engine (int8 KV, one copy of the weights) behind one
  router with metrics, the flight recorder and the live exporter on
  (``/metrics`` scraped over 127.0.0.1 by a second thread and held to
  ``serving_stats()``, the trace sidecar read back against the engines'
  clocks, each replica's service model calibrated from its own steps),
  four times: clean (prefix locality), a replica killed, a replica
  drained, a replica step hung past the router's deadline; every stream
  delivered once in full and every launch held to both replicas'
  forwards; what metrics and tracing cost the bf16 serve run (off, on,
  on, off); one chunk-64 prefill step of the long-context shape
  (1,024-token prompts) profiled by kernel for each KV type.  Ragged
  paged attention is also held and timed at the long-context cell's
  shapes (decode at 2048 tokens a request, chunk-64 prefill) and at a
  speculative step's verify rows, for both pool types;
- training: the four fused decoder-block kernels against their plain
  versions at the bench shape (timed beside the unfused PyTorch
  composition of each block), a small bf16 train step on the card
  against the CPU in f32 with the fused blocks on and off, then
  ``paddle_tpu_torch.bench``'s train step at bench.py's ~0.95B shape
  (S = 2048, AdamW) for warmup + 5 timed steps at the default policy
  (the fused blocks, every launch counted through their four kernels
  and the flash backward), the same unfused (every launch counted
  through the two flash wrappers), and one profiled step of each, its
  device rows summed into classes (GEMMs by library, the port's kernels,
  elementwise, optimizer, copies) that must add up to the busy time;
- distributed training (``paddle_tpu_torch.distributed``): a small bf16
  model's step as 4 ranks on the card over gloo (dp=2 x mp=2, dp=2 x
  sharding=2 with ZeRO-1, dp=4 with the overlapped reduction) against
  world size 1 on the card (``small_dist_check``); bench.py's shape
  through ``Plan().train_step`` at world size 1 over NCCL in turns with
  ``bench.train_step`` (the same launches and loss bits), then as 2
  ranks over gloo at mp=2 and at dp=2 with ZeRO-1 (per-rank peak
  memory, weight and state bytes against their reckoning;
  ``dist_train_phase``); beside those worlds, the eager distributed API
  as 2 gloo ranks (``dist_api_phase``): bench.py's Llama at
  ``BIG_LAYERS`` layers through ``fleet`` at dp=2 (``DataParallel``,
  gradient merge k=2 over AdamW with global-norm clipping, every second
  micro-step under ``fleet.utils.recompute``: its grads bit-equal to a
  plain micro-step's, the launches a micro-step the eager step's, the
  forward's twice under recompute, the all-reduces a backward the
  buckets', the ranks' parameters bit-equal, the first update against
  world size 1), the Llama-width tensor-parallel layers at mp=2 (half
  the weights a rank, loss and gathered grads against world size 1, the
  RNG tracker's masks) and ERNIE-base at pp=2 (bytes a rank, losses
  against world size 1);
- the pipeline and context parallelism: the small model under every
  schedule at dp=2 x pp=2, GPipe with ring attention at pp=2 x sp=2
  and sp=2 alone against world size 1 (``small_pp_check``); bench.py's
  shape as 2 ranks at pp=2 under GPipe, 1F1B lockstep and overlapped
  and interleaved (v=2), 8 microbatches (``pipeline_phase``: weight and
  state bytes against their reckoning, 1F1B's peak below GPipe's,
  launches and ``ppermute`` bytes against the schedule's count, losses
  against world size 1), and at sp=2 (``cp_phase``: the fused MLP on
  the rank's rows, the ring's ``ppermute`` calls and bytes against the
  code's count); ``python -m paddle_tpu_torch.bench --multichip``'s
  line (8 ranks, the recorded schedule equal to the static one).
  The 2-rank worlds at bench.py's width (dist mp=2 / dp=2, pp=2, sp=2)
  run ``BIG_LAYERS`` of its 16 layers, against world size 1 at the same
  depth (``ws1_losses``).  Several ranks on the one card run over gloo, whose point-to-point
  calls cross through host memory: their times are no throughput;
- the MoE layer (experts over dp): a small model's routing in f32, its
  bf16 train loss and its served streams on the card against the CPU
  (``small_moe_check``); bench.py's shape as the reference's llama1b
  preset with 8 experts (4.73e9 parameters) trained at world size 1
  (``moe_train_phase``: step ms, tokens/s, peak memory, the dropped
  share of the assignments, rows 1-8 launched and rows 9-10 not), as 2
  gloo ranks at dp=2 with 4 experts a rank (``moe_dist_phase``: weight
  and state bytes, losses against world size 1, every collective's
  calls and bytes against the code's count) and served by ``LLMEngine``
  over bf16 and int8 KV pages (``moe_serve_phase``: the launches of rows
  11-13 against the forwards).

- the model families' front ends (``models_phase``, on the serve
  phase's llama7b int8 weights): GPT-2 small at full width and depth
  (12 x 768, 12 heads of 64, vocab 50304, bf16) trained 1 + 5 steps at
  B = 8, S = 1024 (AdamW) and 2 more under remat, its flash launches
  exact (12 / 12 a step, 24 / 12 under remat), then
  ``GPTForCausalLM.generate`` (B = 8, 32-token prompts, 64 new tokens,
  greedy: the cached prefill's last logits against ``forward_pure``'s
  within ``GPT_PREFILL_REL_MAX``, its first 8 tokens against an
  uncached greedy); ``llama.generate`` at llama7b over the int8 weights
  (B = 8, 128-token prompts, 32 new tokens, 225 int8 matmuls a forward,
  exact); ``LlamaForCausalLM`` at bench.py's shape (its forward with
  labels launches rows 7-9 16 times each, its logits ``forward_pure``'s
  bit for bit, its loss ``loss_fn``'s within 1e-6, then 16 generated
  tokens); ERNIE-base pretraining (12 x 768, vocab 18000, S = 512, f32,
  TF32 off) at world size 1, 10 steps at B = 32 with 80 masked
  positions a row, the loss falling (step ms, peak memory, MFU against
  the f32 peak); and the train and serve result lines as perf-ledger
  rows in a temporary file, loaded, gated by ``check``, both
  ``real_device``, the repository's ``PERF_LEDGER.jsonl`` unchanged
  (``ledger_phase``).  GPT-2's flash call (B 8, S 1024, H 12, D 64) is
  one of ``flash_phase``'s cases, timed beside SDPA.

- the eager core (``eager_phase``): every case of the op sweep
  (``testing/op_cases.py``: 550 parity cases, bf16 ones for the ops the
  models use, and the random ops' 24 laws) on the card against the
  CPU (``eager_ops <passed>/<total>``); ``LlamaForCausalLM`` at
  bench.py's shape trained the Paddle way, ``set_device("gpu")``,
  ``seed(0)``, ``AdamW(LinearWarmup, ClipGradByGlobalNorm(1.0))``, 6
  steps of ``loss.backward(); opt.step(); opt.clear_grad()`` on one
  batch: step 1's loss and every ``.grad`` bit-equal to
  ``torch.autograd.grad`` of ``forward_pure`` + the reference's
  cross-entropy on the raw tensors, step 1's update bit-equal to the
  reference's AdamW arithmetic written out here, the losses finite and
  falling, the launches a step of rows 7-10 and ``flash_bwd`` equal to
  the functional step's; the eager step, ``optimizer.step()`` and the
  peak beside the functional step's; then GPT-2 small eagerly, 3 steps
  (flash at D 64, 12 / 12 a step) and ``generate`` returning a
  ``Tensor`` equal to the functional ``generate``'s tokens.  The sweep
  holds the vision stack's 38 ops too (``VISION_OPS``: conv, pooling,
  functional vision and extended, geometric, vision.ops).

- the vision stack (``vision_phase``, float32 with TF32 off): the port's
  LeNet example through its ``main`` (30 steps on the card; a run cut
  after step 23 resumes from its committed step 20 and gives the
  uninterrupted losses bit for bit under ``cudnn.deterministic``), then
  ResNet-50 at its published width (1000 classes, 3 x 224 x 224) trained
  by ``Model.fit`` with Momentum(0.1, 0.9) at B = 64 for 8 iterations:
  step ms (steps 3-8), images/s, peak memory and the share of the f32
  peak; the loss finite and the batch norms' statistics moved; one more
  step of each net profiled, its device rows summed into classes
  (cuDNN convolutions, batch norm, elementwise, copies).

- checkpoints, health and the gang runtime (first, after the build): a
  small bf16 model's train state on the card, its newest step's state
  file truncated (``restore()`` falls back to the previous step,
  ``ckpt_restore_fallback_total`` 1) and a save crashed at
  ``ckpt.commit.pre`` in a child process (no visible step, the previous
  one loads) (``small_ckpt_check``); bench.py's shape at world size 1
  through ``Plan().train_step``, saved synchronously at step 2,
  restored into a fresh init (every param and moment equal, steps 3-4
  bit-identical), saved asynchronously at step 4 while steps 5-6 run
  (restored equal), and steps 7-8 with the gang's step-boundary
  snapshot (``ckpt_phase``: bytes on disk against the reckoning, save
  stalls, restore s, peak memory); two ranks of bench.py's width at 4
  layers on the card over gloo through ``python -m
  paddle_tpu_torch.distributed.launch``, once clean and once with rank
  1 killed at step 3's boundary (``gang_phase``: the pod relaunches and
  every step's loss equals the clean pod's bit for bit; detection,
  final save, recovery, steps lost); ``python -m paddle_tpu_torch.bench
  --multichip --gang 2`` (``gang_bench_line``).  The checkpoints go to
  ``_ckpt_smoke/`` (removed after each phase), the pods' logs to
  ``chiprun_out/gang/``.

- mixed precision and the sequence layers (``amp_phase``,
  ``seq_phase``): bench.py's Llama built in float32, ``amp.decorate``
  O2 to bf16 with AdamW's float32 master weights, trained 6 steps under
  ``auto_cast(level="O2")`` with a ``GradScaler`` (step 1's loss and
  unscaled grads bit-equal to the O2 composition by hand, its masters
  bit-equal to the reference's AdamW written out, the launches the
  fused step's; step, ``unscale_`` and ``optimizer.step()`` ms, the peak
  beside 22 B a parameter); Transformer-base (Vaswani et al. 2017: 512
  wide, 8 heads, 6 + 6 layers, a shared 37,000-token vocabulary) under
  O1 bf16 at B 32 x 128 + 128, and under fp16 with a ``GradScaler``
  from 2**32 (the parameters unchanged by every skipped step, the
  skipped-steps counter equal to them); 12 incubate
  ``FusedTransformerEncoderLayer`` at ERNIE-base's width (768, 12
  heads, 3072) at B 32 x 512 with ``LookAhead(AdamW)`` and
  ``ModelAverage``; an LSTM seq2seq (512 wide, 2 layers) beam-searching
  (beam 4, 32 steps, B 16) to the CPU's tokens on the same weights;
  LBFGS with strong Wolfe on 4096 x 1024 least squares within 1e-3 of
  ``lstsq``; and each path small in float32 on the card against the CPU.

Any failure exits non-zero.  The last two lines of standard output are
the card's name and power limit (from nvidia-smi) and, last,
``{"ok": true, "device": {...}}``; the line before them is the
``kernels`` JSON object.

    python3 chip_smoke.py --against DIR

runs, instead, a parent commit's ``paddle_tpu_torch`` (unpacked by ``git
archive`` into DIR, a directory ``.gitignore`` lists) against this
tree's in turns, parent, change, change, parent, in one process on one
card (``compare_turns``): the four fused-block kernels and the flash
backward (D 128 and 64) per call at the bench shape, and the bench's
train step fused and unfused.
"""
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# tensor-core ops/s per input type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, calls, replays=5):
    """Device ms per call: ``calls`` calls of ``fn(i)`` captured in one
    CUDA graph and replayed ``replays`` times between CUDA events, so the
    host's launch overhead stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up outside the capture
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def eager_ms(torch, fn, calls):
    """Ms per call of ``fn(i)`` launched back to back from Python, as the
    eager engine launches it: device time plus whatever the host adds."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_ms(torch, fn, calls):
    """Host ms a call: ``calls`` calls of ``fn(i)`` issued back to back
    with no sync, on the host's clock.  Where the kernel takes less than
    its launch (the serve cell's shapes) the card never holds the host
    back, so this is the wrapper's and the launch's host cost."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * wall / calls


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

# llama7b's int8 matmuls: (K, N) -> calls per forward step (7 per layer
# x 32 layers + lm_head)
INT8_SHAPES = {(4096, 4096): 4 * 32, (4096, 11008): 2 * 32,
               (11008, 4096): 1 * 32, (4096, 32000): 1}
# rows of one call: a decode step of 8 requests, the default cell's
# prefill chunk (8 x 8), the long-context cell's (8 x 64) and the prefill
# of llama7b's ``generate`` (``LLAMA_GEN``: 8 x 128)
INT8_ROWS = (8, 64, 512, 1024)


def int8_inputs(torch, i8, gen, M, K, N):
    """bf16 activations N(0, 1) and int8 weights of N(0, 0.02), plus
    enough copies of the weights to exceed L2: the weights of one call
    are cold in a real step (every layer has its own)."""
    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    wq, ws = i8.quantize_int8(w)
    del w
    copies = [wq] + [wq.clone() for _ in
                     range(max(0, math.ceil(160e6 / wq.numel()) - 1))]
    return x, wq, ws, copies


def int8_phase(torch, i8):
    """The int8 matmul against its plain version (``torch.equal``) at
    every llama7b shape and every M of ``INT8_ROWS``; kernel, eager, plain
    and ``torch._int_mm`` times and the bound.  Takes the module, so the
    parent's package can run through the same function."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(1)
    out, max_err = [], 0.0
    for M in INT8_ROWS:
        for (K, N), calls in INT8_SHAPES.items():
            x, wq, ws, copies = int8_inputs(torch, i8, gen, M, K, N)
            y = i8.int8_matmul(x, wq, ws)
            ref = i8._int8_matmul_plain(x, wq, ws)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            check(torch.equal(y, ref),
                  f"int8_matmul M={M} K={K} N={N} not bit-identical "
                  f"(max |diff| {err})")
            max_err = max(max_err, err)

            def kern(i):
                return i8.int8_matmul(x, copies[i % len(copies)], ws)

            ms = time_ms(torch, kern, calls=20)
            launch_ms = eager_ms(torch, kern, calls=50)
            plain_ms = time_ms(torch, lambda i: i8._int8_matmul_plain(
                x, copies[i % len(copies)], ws), calls=4, replays=2)
            lib = int_mm_ms(torch, i8, x, copies, ws)
            lib_ms = min((v for v in lib.values() if v is not None),
                         default=None)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, "int8")
            out.append(dict(M=M, K=K, N=N, calls=calls, ms=ms,
                            eager_ms=launch_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, int_mm=lib, bound_ms=b_ms,
                            bound_by=b_by, bytes=nbytes, ops=2 * M * K * N))
            libs = "  ".join(f"_int_mm {k} "
                             f"{'n/a' if v is None else f'{v:.4f} ms'}"
                             for k, v in lib.items())
            print(f"int8_matmul M={M:3d} K={K:5d} N={N:5d}: kernel "
                  f"{ms:.4f} ms (eager {launch_ms:.4f})  plain "
                  f"{plain_ms:.4f} ms  {libs}  bound {b_ms:.4f} ms "
                  f"({b_by})  bit-identical")
            del copies, wq, ws, x, y, ref
    return out, max_err


def int8_step(rows, M):
    """One forward step's 225 calls at ``M`` rows, summed from the
    per-call rows of ``int8_phase``."""
    sel = [r for r in rows if r["M"] == M]
    step = {k: sum(r["calls"] * r[k] for r in sel)
            for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bytes",
                      "ops")}
    step["library_ms"] = (None if any(r["library_ms"] is None for r in sel)
                          else sum(r["calls"] * r["library_ms"] for r in sel))
    _, step["bound_by"] = bound_ms(step["bytes"], step["ops"], "int8")
    return step


# the regimes side by side on calls the stream regime can serve (its
# stream_rows): where they cross sets ``_STREAM_MAX_M``
INT8_REGIMES = (("stream", 16), ("rows", 0))


def int8_plans(torch, i8):
    """Calls of M = 8 and 16 rows run through both regimes, each held to
    the plain version, their graph-replayed ms side by side."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(2)
    out = []
    for M in (8, 16):
        for (K, N) in INT8_SHAPES:
            x, wq, ws, copies = int8_inputs(torch, i8, gen, M, K, N)
            ref = i8._int8_matmul_plain(x, wq, ws)
            res = {}
            for name, sr in INT8_REGIMES:
                check(torch.equal(i8._int8_matmul_cuda(
                    x, wq, ws, stream_rows=sr), ref),
                    f"int8_matmul {name} regime M={M} K={K} N={N} not "
                    f"bit-identical")
                res[name] = time_ms(torch, lambda i: i8._int8_matmul_cuda(
                    x, copies[i % len(copies)], ws, stream_rows=sr),
                    calls=20)
            out.append(dict(M=M, K=K, N=N, **res))
            print(f"int8_matmul regimes M={M:3d} K={K:5d} N={N:5d}: "
                  + "  ".join(f"{n} {v:.4f} ms" for n, v in res.items()))
            del copies, wq, ws, x, ref
    return out


def int_mm_ms(torch, i8, x, copies, ws):
    """torch._int_mm (cuBLASLt) plus the dequant epilogue on the same
    int8 operands, the weights given as stored ([K, N] row-major) and
    K-contiguous (the same matrix, ``w.t().contiguous().t()``: the
    layout cuBLASLt's int8 tensor-core kernels take without a
    transpose).  _int_mm needs more than 16 rows, so smaller M is padded
    to 32 zero rows."""
    xq, xs = i8._quantize_rows(x.float())
    M = xq.shape[0]
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros((32 - M, xq.shape[1]))])
    res = {}
    for name, ws_ in (("row_major", copies),
                      ("k_contiguous", [w.t().contiguous().t()
                                        for w in copies])):
        def run(i):
            acc = torch._int_mm(xq, ws_[i % len(ws_)])[:M]
            return ((acc.float() * xs) * ws).to(x.dtype)

        try:
            run(0)
        except RuntimeError as exc:  # a library limit, not the port's kernel
            print(f"  torch._int_mm ({name}) unavailable here: {exc}")
            res[name] = None
            continue
        res[name] = time_ms(torch, run, calls=20)
        del ws_
    return res


# R = 8 slots, llama7b's heads; mixed kv lengths with an empty slot and
# chunks across page boundaries; GQA (rep = 4); one decode at a context
# users serve: 2048 tokens a request (Bmax 128, P 1025); the same with
# ragged lengths (load balance, split edges, an empty slot, lengths off a
# page boundary); a GQA decode at 2048 tokens; the long-context cell's
# chunk-64 prefill steps with decode rows mixed in; and a speculative
# step in the Tc = chunk bucket: verify rows (q_len 1 + k = 4) at deep
# positions beside a prefill row, decode rows and an empty slot
RPA_CASES = [
    ("prefill_tc8", 32, 1, 8, [8, 20, 0, 33, 24, 16, 40, 9],
     [8, 4, 0, 8, 8, 3, 8, 2]),
    ("decode_tc1", 32, 1, 1, [1, 17, 33, 40, 0, 9, 2, 25],
     [1, 1, 1, 1, 0, 1, 1, 1]),
    ("gqa_rep4_tc8", 8, 4, 8, [8, 20, 0, 33, 24, 16, 40, 9],
     [8, 4, 0, 8, 8, 3, 8, 2]),
    ("decode_long", 32, 1, 1, [2048] * 8, [1] * 8),
    ("decode_long_ragged", 32, 1, 1, [2048, 1, 700, 0, 1500, 33, 2047, 16],
     [1, 1, 1, 0, 1, 1, 1, 1]),
    ("gqa_long_rep4", 8, 4, 1, [2048] * 8, [1] * 8),
    ("prefill_long_tc64", 32, 1, 64, [1024, 64, 577, 0, 1000, 130, 900,
                                      1088], [64, 64, 64, 0, 1, 64, 1, 64]),
    ("spec_verify", 32, 1, 8, [2048, 1500, 8, 700, 0, 33, 2047, 1024],
     [4, 4, 8, 1, 0, 1, 4, 4]),
]
RPA_R, RPA_D, RPA_PAGE = 8, 128, 16


def rpa_inputs(torch, rng, case, quant):
    """One case's inputs on the card: bf16 q, and pools drawn N(0, 1) —
    bf16, or quantized per (kv head, page) as the engine writes them
    (scale = absmax / 127, int8 = round(x / scale)) with their f32
    scales.  The block table maps every request to distinct pages."""
    dev = torch.device("cuda")
    name, nkv, rep, Tc, lens_l, qlens_l = case
    R, d, page = RPA_R, RPA_D, RPA_PAGE
    Bmax = max(3, -(-max(lens_l) // page))
    P = max(64, R * Bmax + 1)
    q = torch.from_numpy(rng.standard_normal((R, nkv, Tc * rep, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    pools, scales = [], []
    for _ in range(2):
        x = torch.randn((nkv, P, page, d), generator=gen, device=dev)
        if quant:
            sc = x.abs().amax(dim=(2, 3)).clamp_min(1e-8) / 127.0
            pools.append(torch.round(x / sc[:, :, None, None]).clamp_(
                -127, 127).to(torch.int8))
            scales.append(sc.contiguous())
        else:
            pools.append(x.to(torch.bfloat16))
        del x
    tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                           .reshape(R, Bmax).astype(np.int32)).to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    qlens = torch.tensor(qlens_l, dtype=torch.int32, device=dev)
    return (q, pools[0], pools[1], tbl, lens, qlens), scales


def rpa_dense_kv(torch, args, scales):
    """Each request's K and V gathered (and dequantized) into dense
    [R, nkv, Bmax * page, d] bf16: SDPA's inputs for the same
    function."""
    q, kp, vp, tbl = args[:4]
    R, nkv, _, d = q.shape
    S = tbl.shape[1] * kp.shape[2]
    flat = tbl.reshape(-1).long()
    dense = []
    for i, pool in enumerate((kp, vp)):
        x = pool.index_select(1, flat)
        if scales:
            x = x.float() * scales[i].index_select(1, flat)[:, :, None, None]
        dense.append(x.to(torch.bfloat16).reshape(nkv, R, S, d)
                     .transpose(0, 1).contiguous())
    return dense


def rpa_mask(torch, lens, qlens, Tr, rep, S, drop_blk=None, page=None):
    """[R, Tr, S] keys each q row may see (the kernel's predicate), with
    logical block ``drop_blk`` of every request hidden when given."""
    dev = lens.device
    tok = torch.arange(Tr, device=dev) // rep
    qpos = (lens - qlens)[:, None] + tok[None, :]
    kpos = torch.arange(S, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < lens[:, None, None])
            & (tok[None, :, None] < qlens[:, None, None]))
    if drop_blk is not None:
        mask &= (kpos // page != drop_blk)[None, None, :]
    return mask


def rpa_control(torch, args, scales, rep):
    """The limits against a wrong kernel: ragged attention in f32 that
    drops logical page 0 of every request (every row of an active
    request sees it), read against the plain version.  It fails unless
    it breaks the per-row limit."""
    q, kp, vp, tbl, lens, qlens = args
    kd, vd = rpa_dense_kv(torch, args, scales)
    Tr, page = q.shape[2], kp.shape[2]
    mask = rpa_mask(torch, lens, qlens, Tr, rep, kd.shape[2], 0, page)
    s = torch.einsum("rhtd,rhsd->rhts", q.float(), kd.float()) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(s.masked_fill(~mask[:, None], -1e30), dim=-1)
    o = torch.einsum("rhts,rhsd->rhtd", p, vd.float())
    tok = torch.arange(Tr, device=q.device) // rep
    return torch.where((tok[None, :] < qlens[:, None])[:, None, :, None],
                       o, 0.0)


def rpa_bounds(case, quant):
    """(bytes, ops) the function needs on this case's data: q read and
    out written once, the K and V of every visible token once (bf16: 2
    bytes an element; int8: 1, plus two f32 scales per visible page and
    kv head), q.k and p.v for every visible (q row, key) pair."""
    name, nkv, rep, Tc, lens_l, qlens_l = case
    d, page = RPA_D, RPA_PAGE
    active = [(L, ql) for L, ql in zip(lens_l, qlens_l) if ql]
    visible = sum(L for L, _ in active)
    pages = sum(-(-L // page) for L, _ in active)
    pairs = sum(ql * rep * ((L - ql) + (ql + 1) / 2) for L, ql in active)
    qbytes = 2 * RPA_R * nkv * Tc * rep * d * 2
    kv = 2 * visible * nkv * d * (1 if quant else 2)
    if quant:
        kv += 2 * pages * nkv * 4
    return qbytes + kv, 4 * pairs * nkv * d


def rpa_phase(torch, rpa, quant=False):
    """Ragged paged attention against its plain version on every case:
    bf16 pools (the kernel replacing _rpa_kernel) or, with ``quant``,
    int8 pools and scales (the one replacing _rpa_kernel_quant).  Each
    row of the output within ``ROW_REL_MAX`` of its RMS, the tensor
    within ``NORM_REL_MAX``, max |diff| <= 2e-2, padding exact zeros, and
    a control that drops one visible page must break the row limit.
    Timed per call by graph replay and eager, beside the plain version,
    the bound and SDPA over the same (dequantized) KV gathered dense
    outside the timed call (a yardstick the port never calls)."""
    F = torch.nn.functional
    rng = np.random.RandomState(3 if quant else 2)
    tag = "ragged_paged_attention" + ("_quant" if quant else "")
    rows, max_err = [], 0.0
    for case in RPA_CASES:
        name, nkv, rep, Tc, lens_l, qlens_l = case
        args, scales = rpa_inputs(torch, rng, case, quant)
        kw = dict(k_scales=scales[0], v_scales=scales[1]) if quant else {}
        q, kp, vp, tbl, lens, qlens = args
        out = rpa.ragged_paged_attention(*args, rep=rep, **kw)
        ref = rpa._ragged_attention_plain(*args, rep, *scales)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row = rms_rel(out, ref, True)
        norm = rms_rel(out, ref, False)
        ctl = rms_rel(rpa_control(torch, args, scales, rep), ref, True)
        tok = torch.arange(Tc * rep, device=q.device) // rep
        pad = (tok[None, :] >= qlens[:, None])[:, None, :, None].expand_as(
            out)
        pad_zero = not out[pad].any().item()
        check(err <= 2e-2, f"{tag} {name}: max |diff| {err} > 2e-2")
        check(row <= ROW_REL_MAX, f"{tag} {name}: row rel {row} > "
              f"{ROW_REL_MAX}")
        check(norm <= NORM_REL_MAX, f"{tag} {name}: norm rel {norm} > "
              f"{NORM_REL_MAX}")
        check(ctl > ROW_REL_MAX, f"{tag} {name}: control (page 0 dropped) "
              f"row rel {ctl} passes the limit {ROW_REL_MAX}")
        check(pad_zero, f"{tag} {name}: padding rows not exact zeros")
        max_err = max(max_err, err)

        def kern(i):
            return rpa.ragged_paged_attention(*args, rep=rep, **kw)

        ms = time_ms(torch, kern, calls=50)
        launch_ms = eager_ms(torch, kern, calls=100)
        wrap_ms = host_ms(torch, kern, calls=500)
        plain_ms = time_ms(torch, lambda i: rpa._ragged_attention_plain(
            *args, rep, *scales), calls=10)
        kd, vd = rpa_dense_kv(torch, args, scales)
        mask = rpa_mask(torch, lens, qlens, Tc * rep, rep,
                        kd.shape[2])[:, None]
        lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), calls=50)
        del kd, vd, mask
        nbytes, ops = rpa_bounds(case, quant)
        b_ms, b_by = bound_ms(nbytes, ops, "bf16")
        plan = rpa._plan_for(q, kp, tbl)
        rows.append(dict(name=name, nkv=nkv, rep=rep, Tc=Tc, S=plan.S,
                         tile_rows=plan.rows, ms=ms,
                         eager_ms=launch_ms, host_ms=wrap_ms,
                         plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=ops, max_abs_err=err,
                         row_rel_err=row, norm_rel_err=norm,
                         control_row_rel_err=ctl))
        print(f"{tag} {name} (S={plan.S}, {plan.rows}-row tiles): kernel "
              f"{ms:.4f} ms (eager {launch_ms:.4f}, host {wrap_ms:.4f})  "
              f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
              f"{b_ms:.6f} ms ({b_by}, {nbytes / 1e6:.3f} MB)  max |diff| "
              f"{err:.3g}  row rel {row:.3g}  norm rel {norm:.3g}  control "
              f"row rel {ctl:.3g}  padding exact 0")
        del args, scales, out, ref
    return rows, max_err


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def small_reference_check(torch, tllama, convert, rpa):
    """One mixed prefill + decode step of a small float32 model with int8
    weights, over float32 KV pages and over int8 pages with scales: the
    card (every kernel of the step) against the CPU (plain versions).
    They agree to float32 summation order, except where an activation
    sits within an ulp of an int8 rounding boundary on one side only;
    each such flip moves an output by at most x_scale * max|w| (~3e-3
    here), hence atol 1e-2 on logits and f32 pages.  int8 pages: the
    bytes equal except +-1 at a rounding tie on at most 0.1 % of them,
    the scales within 1e-5 relative (absmaxes of differently summed
    products), the null page untouched."""
    cfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, quantized="on")
    params = tllama.quantize_params(
        cfg, tllama.init_params(cfg, 0, device="cpu"))
    rng = np.random.RandomState(0)
    R, Tc, P, page, Bmax = 4, 8, 16, 16, 3
    shape = (2, 1, P, page, 128)
    pools = {
        "f32": [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for _ in range(2)],
        # earlier tokens' int8 bytes and scales, as a previous step left
        "int8": [torch.from_numpy(rng.randint(-127, 128, shape).astype(
            np.int8)) for _ in range(2)]
        + [torch.from_numpy(rng.uniform(0.005, 0.03, shape[:3]).astype(
            np.float32)) for _ in range(2)]}
    for t in pools["int8"]:
        t[:, :, 0] = 0 if t.dtype == torch.int8 else 1.0
    tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                           .reshape(R, Bmax).astype(np.int32))
    lens = torch.tensor([8, 21, 0, 40], dtype=torch.int32)
    qlens = torch.tensor([8, 1, 0, 6], dtype=torch.int32)
    tokens = torch.from_numpy(rng.randint(0, 512, (R, Tc)).astype(np.int32))
    for kind, init in pools.items():
        outs = []
        for dev in ("cpu", "cuda"):
            t = [x.clone().to(dev) for x in init]
            sc = dict(k_scales=t[2], v_scales=t[3]) if len(t) == 4 else {}
            before = rpa.ragged_paged_attention.quant_launches
            with torch.no_grad():
                logits, _ = tllama.forward_paged(
                    cfg, convert.params_to(params, dev), tokens.to(dev),
                    t[0], t[1], tbl.to(dev), lens.to(dev), qlens.to(dev),
                    **sc)
            if dev == "cuda" and sc:
                check(rpa.ragged_paged_attention.quant_launches
                      == before + 2, "the int8 attention kernel did not run")
            outs.append([logits.cpu()] + [x.cpu() for x in t])
        check(all(torch.isfinite(o[0]).all() for o in outs),
              "non-finite logits")
        err = max((outs[0][0][r, :q] - outs[1][0][r, :q]).abs().max().item()
                  for r, q in enumerate(qlens.tolist()) if q)
        if kind == "f32":
            for a, b in zip(outs[0][1:], outs[1][1:]):
                err = max(err, (a[:, :, 1:] - b[:, :, 1:]).abs().max().item())
            check(err <= 1e-2, f"small model: card vs CPU max |diff| {err} "
                  f"> 1e-2")
            print(f"small model step (f32, int8 weights, f32 pages): card vs "
                  f"CPU max |diff| {err:.3g} (atol 1e-2)")
            continue
        check(err <= 1e-2, f"small model int8 KV: card vs CPU logits max "
              f"|diff| {err} > 1e-2")
        flips = 0
        for a, b in zip(outs[0][1:3], outs[1][1:3]):
            d = a.int() - b.int()
            check(d.abs().max().item() <= 1, "small model int8 KV: a page "
                  "byte differs by more than 1")
            flips += d.count_nonzero().item()
            check(not b[:, :, 0].any(), "the null page was written")
        check(flips <= 1e-3 * 2 * outs[0][1].numel(), f"small model int8 "
              f"KV: {flips} bytes differ")
        sc_err = max(((b - a).abs() / a.abs()).max().item()
                     for a, b in zip(outs[0][3:], outs[1][3:]))
        check(sc_err <= 1e-5, f"small model int8 KV: scales rel {sc_err}")
        print(f"small model step (f32, int8 weights, int8 pages): card vs "
              f"CPU logits max |diff| {err:.3g} (atol 1e-2), {flips} page "
              f"bytes off by 1, scales rel {sc_err:.3g}")


# the serve runs of one call: (name, kv dtype, workload, SPEC_K); the
# shared-prefix workload runs as the reference's (prefix cache + self-draft
# speculation, k = 3) and once with speculation off
SERVE_RUNS = (("bf16", "bf16", "uniform", None),
              ("int8", "int8", "uniform", None),
              ("int8_shared_prefix", "int8", "shared-prefix", "3"),
              ("int8_shared_prefix_spec0", "int8", "shared-prefix", "0"))
# what the spec run's peak memory may exceed the spec-off run's by, above
# the draft's pools (its transients: logits and argmax of a Tc = 1 step)
SPEC_MEMORY_MARGIN = 128 << 20


def check_launches(launches, forwards, L, quant, tag):
    """Every serving kernel's launches against the engines' forwards by
    kind (one engine's ``forwards`` dict, or a list of them summed: the
    replicas behind a router): each forward runs 7 L + 1 int8 matmuls
    and L attention calls, over the target's pools (its step and the
    probes: row 12 with int8 pages, else row 11) or the draft's (mirror
    and proposals: row 11, whatever the target's pages)."""
    if isinstance(forwards, list):
        forwards = {kind: sum(f[kind] for f in forwards)
                    for kind in forwards[0]}
    target = forwards["target"] + forwards["probe"]
    draft = forwards["mirror"] + forwards["propose"]
    want = {"int8_matmul": (7 * L + 1) * (target + draft),
            "ragged_paged_attention": L * (draft + (0 if quant else target)),
            "ragged_paged_attention_quant": L * target if quant else 0}
    for k, v in want.items():
        check(launches[k] == v, f"{tag}: {k} launched {launches[k]} times, "
              f"expected {v} for the forwards {forwards}")


def serve_phase(torch, tllama, bench_serve, card):
    """The serving main path through ``bench_serve``'s measuring
    function: llama7b at full width and depth, int8 weights built once,
    served four times in one call (bf16 KV; int8 KV; int8 KV with the
    shared-prefix workload, the prefix cache and self-draft speculation
    at k = 3; the same with speculation off), each uniform run followed
    by its profiles (``profile_steps``, ``prefill_profile``), the spec
    run by ``profile_steps``.  Every
    launch of the three serving kernels is counted from 0 over each run
    (its warm-up included) and held against the engine's forwards by
    kind; the KV pool bytes against their formula; the spec run's peak
    memory against the spec-off run's plus the draft's pools.  Returns
    the runs and the weights (for ``recovery_phase``)."""
    cfg = tllama.preset("llama7b")
    L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    t0 = time.perf_counter()
    params = tllama.quantize_params(
        cfg, tllama.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    print(f"llama7b int8 weights built: {time.perf_counter() - t0:.1f} s")
    runs, outputs = {}, {}
    for name, kv_dtype, workload, spec_k in SERVE_RUNS:
        bench_serve.reset_kernel_launches()
        env = "PADDLE_TPU_BENCH_SERVE_SPEC_K"
        if spec_k is not None:
            os.environ[env] = spec_k
        try:
            run = bench_serve.serve("cuda", kv_dtype=kv_dtype,
                                    workload=workload, params=params)
        finally:
            os.environ.pop(env, None)
        launches = bench_serve.kernel_launches()
        eng, res = run.engine, run.result
        steps = eng._steps
        reqs = [eng.request(r) for r in run.rids]
        n_new = res["new_tokens"]
        check(all(r.state.value == "finished" and len(r.output) == n_new
                  for r in reqs), f"serve {name}: a request did not finish "
              f"with {n_new} tokens")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
              f"serve {name}: a token id out of the vocabulary")
        check(eng.kv.audit()["ok"], f"serve {name}: page books not "
              f"balanced: {eng.kv.audit()}")
        check(isinstance(eng.params["layers"]["wq"], dict),
              f"serve {name}: the weights are not int8")
        fw = dict(eng.forwards)
        check(fw["target"] == steps and fw["probe"] == 0,
              f"serve {name}: forwards {fw} over {steps} steps")
        quant = kv_dtype == "int8"
        check_launches(launches, fw, L, quant, f"serve {name}")
        page, P = eng.page_size, eng.num_pages
        pool = 2 * L * nkv * P * page * d * (1 if quant else 2)
        scales = 2 * L * nkv * P * 4 if quant else 0
        held = sum(t.numel() * t.element_size() for t in
                   (eng._kp, eng._vp, eng._ks, eng._vs) if t is not None)
        check(eng._pool_bytes == pool + scales == held,
              f"serve {name}: pool bytes {eng._pool_bytes} (held {held}), "
              f"formula {pool} + {scales}")
        if workload == "shared-prefix":
            reuse = res["reuse"]
            check(reuse["prefix_hit_tokens"] > 0,
                  f"serve {name}: no prefix hit")
            if spec_k == "3":
                check(0 < reuse["spec_accepted"] <= reuse["spec_proposed"],
                      f"serve {name}: spec accepted {reuse['spec_accepted']}"
                      f" of {reuse['spec_proposed']}")
                check(eng._draft.params is eng.params, f"serve {name}: the "
                      f"self-draft holds a second copy of the weights")
                check(eng._draft._kp.dtype == torch.bfloat16 and
                      reuse["draft_pool_bytes"] == 2 * L * nkv * P * page
                      * d * 2, f"serve {name}: draft pools")
                check(fw["mirror"] == steps and fw["propose"] > 0,
                      f"serve {name}: forwards {fw}")
            else:
                check(reuse["spec_proposed"] == 0 and eng._draft is None,
                      f"serve {name}: speculation ran with SPEC_K=0")
        res["launches"] = launches
        res["forward_steps"] = steps
        res["forwards_all"] = fw
        runs[name] = res
        outputs[name] = [list(r.output) for r in reqs]
        print(f"serve {name} [{card}]: BENCH_SERVE {json.dumps(res)}")
        reuse = res.get("reuse", {})
        print(f"serve {name} [{card}]: {res['tokens']} tokens in "
              f"{res['wall_seconds']:.3f} s = {res['value']:.2f} tokens/s, "
              f"TTFT p50 {res['ttft_p50_ms']:.2f} ms p95 "
              f"{res['ttft_p95_ms']:.2f} ms, decode step "
              f"{res['decode_step_ms']} ms ({res['decode_steps']} steps), "
              f"verify step {res['verify_step_ms']} ms "
              f"({res['verify_steps']} steps), prefill step "
              f"{res['prefill_step_ms']} ms (means), forwards "
              f"{res['forwards']} = {res['forwards_per_step']:.3f} a step, "
              f"spec acceptance {reuse.get('spec_acceptance_rate')}, "
              f"max_memory_allocated {res['max_memory_allocated']} bytes, "
              f"KV pools {eng._pool_bytes} bytes, launches {launches} over "
              f"{steps} forward steps ({fw})")
        if workload == "uniform" or spec_k == "3":
            prompts, _, _ = bench_serve.prompts_for(
                workload, bench_serve.knobs(), cfg.vocab_size)
            profile_steps(torch, eng, prompts[:8], f"{card}, {name} KV")
        del run, eng
        if workload == "uniform":   # the pools above are freed first
            prefill_profile(torch, bench_serve.serving, cfg, params,
                            kv_dtype, f"{card}, {name} KV")
    same = sum(a == b for x, y in zip(outputs["bf16"], outputs["int8"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in outputs["bf16"])
    print(f"serve [{card}]: int8 KV tokens equal to the bf16 run's: "
          f"{same}/{total} ({100 * same / total:.1f} %; not gated: random "
          f"weights give tiny argmax margins)")
    on, off = runs["int8_shared_prefix"], runs["int8_shared_prefix_spec0"]
    extra = on["max_memory_allocated"] - off["max_memory_allocated"]
    draft = on["reuse"]["draft_pool_bytes"]
    check(extra <= draft + SPEC_MEMORY_MARGIN, f"serve: the spec run's peak "
          f"exceeds the spec-off run's by {extra} bytes, more than the draft "
          f"pools {draft} + {SPEC_MEMORY_MARGIN}")
    same = sum(a == b for x, y in zip(outputs["int8_shared_prefix"],
                                      outputs["int8_shared_prefix_spec0"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in outputs["int8_shared_prefix"])
    print(f"serve [{card}]: spec on vs off (int8 KV, shared prefix): "
          f"{on['value']:.2f} vs {off['value']:.2f} tokens/s, acceptance "
          f"{on['reuse']['spec_acceptance_rate']:.4f}, forwards a step "
          f"{on['forwards_per_step']:.3f} vs {off['forwards_per_step']:.3f},"
          f" peak memory +{extra} bytes (draft pools {draft}); tokens equal "
          f"{same}/{total} (not gated: int8 pages take the rejected tail "
          f"into the page absmax, and bf16 verify and decode tiles sum in "
          f"other orders)")
    return runs, params


# the recovery runs: (name, chaos rule, serve.step deadline in s or None);
# "{rid}" is the rid of the 4th request.  The hang sleeps 2 s on the host
# in a step whose deadline is 1 s, far above a llama7b step's device work
RECOVERY_RUNS = (("transient", "fail@serve.step:step=2,times=1", None),
                 ("quarantine", "fail@serve.step:rid={rid}", None),
                 ("hang", "hang@serve.step:step=3,times=1,secs=2.0", 1.0))


def recovery_phase(torch, tllama, serving, chaos, watchdog, bench_serve,
                   params, card):
    """Crash recovery at llama7b on the card: int8 KV, the prefix cache
    and self-draft speculation at k = 3, 8 shared-prefix requests of the
    bench's shape, one fresh engine a run under an injected fault: a
    transient step failure (everyone finishes, one recovery, one probe),
    a request-scoped poison (that request ends FAILED with
    RequestQuarantined, the other 7 finish, at most 1 + 2 ceil(log2 8)
    probes) and a step that comes back past its serve.step deadline
    (classified a hang, no probe, everyone replays).  Every run's books
    balance and every kernel launch equals the engine's forwards by
    kind, probes included; the recovered step's wall time is printed."""
    cfg = tllama.preset("llama7b")
    L = cfg.num_hidden_layers
    k = bench_serve.knobs()
    prompts, _, _ = bench_serve.prompts_for("shared-prefix", k,
                                            cfg.vocab_size)
    prompts = prompts[:8]
    n_new, chunk = k["NEW"], k["CHUNK"]
    out = {}
    for name, rule, deadline in RECOVERY_RUNS:
        wd = (watchdog.Watchdog(deadlines={"serve.step": deadline},
                                dump=False) if deadline else None)
        eng = serving.LLMEngine(
            cfg, params, device="cuda", max_running=8, chunk=chunk,
            page_size=k["PAGE"], max_model_len=k["PROMPT"] + n_new + chunk,
            kv_dtype="int8", prefix_cache=True, watchdog=wd,
            spec=serving.SpecDecodeConfig(cfg, params, k=3))
        probes = []
        probe = eng._probe
        eng._probe = lambda group: probes.append(len(group)) or probe(group)
        rids = [eng.add_request(p, n_new) for p in prompts]
        poison = rids[3]
        serving.reset_stats()
        watchdog.clear_incidents()
        bench_serve.reset_kernel_launches()
        walls = []
        with chaos.installed(chaos.Chaos(rule.format(rid=poison))) as c:
            while eng.has_work():
                before = serving.serving_stats()["recoveries"]
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0,
                              serving.serving_stats()["recoveries"] > before))
                check(len(walls) < 500, f"recovery {name}: no convergence")
        launches = bench_serve.kernel_launches()
        stats = serving.serving_stats()
        reqs = [eng.request(r) for r in rids]
        fw = dict(eng.forwards)
        tag = f"recovery {name}"
        check(len(c.log) >= 1, f"{tag}: the fault never fired")
        check(stats["recoveries"] == 1, f"{tag}: {stats['recoveries']} "
              f"recoveries, not 1")
        check(eng.kv.audit()["ok"], f"{tag}: books {eng.kv.audit()}")
        check_launches(launches, fw, L, True, tag)
        check(fw["probe"] <= len(probes), f"{tag}: forwards {fw}")
        rec = watchdog.last_incident()
        failed = [r for r in reqs if r.state.value != "finished"]
        if name == "quarantine":
            check([r.rid for r in failed] == [poison]
                  and failed[0].state.value == "failed"
                  and isinstance(failed[0].error,
                                 serving.RequestQuarantined),
                  f"{tag}: request {poison} not quarantined "
                  f"({[(r.rid, r.state.value) for r in failed]})")
            check(stats["quarantined"] == 1 and rec["culprit"] == poison,
                  f"{tag}: {stats['quarantined']} quarantined, incident "
                  f"{rec}")
            check(len(probes) <= 1 + 2 * 3, f"{tag}: {len(probes)} probes")
        else:
            check(not failed and stats["quarantined"] == 0,
                  f"{tag}: {len(failed)} requests failed")
            want = {"transient": "injected", "hang": "hang"}[name]
            check(rec["failure"] == want, f"{tag}: classified "
                  f"{rec['failure']}, not {want}")
            check(len(probes) == (1 if name == "transient" else 0),
                  f"{tag}: {len(probes)} probes")
        check(all(len(r.output) == n_new for r in reqs if r not in failed),
              f"{tag}: a request finished short of {n_new} tokens")
        rec_ms = [1e3 * w for w, r in walls if r]
        other = [1e3 * w for w, r in walls if not r]
        out[name] = dict(recovered_step_ms=rec_ms[0], probes=len(probes),
                         steps=len(walls), forwards=fw,
                         mean_other_step_ms=float(np.mean(other)),
                         failure=rec["failure"], launches=launches)
        print(f"{tag} [{card}]: rule {c.rules[0]!r}, failure "
              f"{rec['failure']}, recovered step {rec_ms[0]:.2f} ms "
              f"(rebuild + {len(probes)} probes; the other "
              f"{len(other)} steps {np.mean(other):.2f} ms on average), "
              f"forwards {fw}, launches {launches}, "
              f"{sum(r.state.value == 'finished' for r in reqs)}/8 "
              f"finished")
        eng.shutdown()
        del eng
    return out


def small_spec_check(torch, tllama, serving, chaos):
    """Speculation's streams on the card against the CPU: a small
    float32 model with dense weights (``small_reference_check``'s
    shape), 8 requests over 2 system prompts, served four ways on each
    device: spec off, self-draft spec at k = 3, spec with the prefix
    cache, and spec with the prefix cache under an injected step failure
    (``fail@serve.step:step=2``).  All eight runs give the same streams,
    token for token.  A mismatch prints the top-2 logit margin at the
    first differing position (a near tie reads apart from a fault)."""
    cfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, quantized="off")
    params = tllama.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(4)
    heads = [[int(t) for t in rng.randint(1, 512, n)] for n in (21, 13)]
    prompts = [heads[i % 2] + [int(t) for t in rng.randint(1, 512, 2 + i)]
               for i in range(8)]
    n_new = 12
    ways = (("spec_off", False, False, None), ("spec", True, False, None),
            ("spec_prefix", True, True, None),
            ("spec_prefix_fail", True, True,
             "fail@serve.step:step=2,times=1"))
    streams, stats = {}, {}
    for dev in ("cpu", "cuda"):
        for name, spec, prefix, rule in ways:
            eng = serving.LLMEngine(
                cfg, params, device=dev, max_running=4, chunk=8,
                page_size=16, max_model_len=64, prefix_cache=prefix,
                spec=serving.SpecDecodeConfig(cfg, params) if spec else None)
            serving.reset_stats()
            with chaos.installed(chaos.Chaos(rule or "")):
                rids = [eng.add_request(p, n_new) for p in prompts]
                eng.run()
            streams[dev, name] = [eng.output_of(r) for r in rids]
            stats[dev, name] = serving.serving_stats()
            check(eng.kv.audit()["ok"], f"small spec {dev} {name}: books")
            check(stats[dev, name]["recoveries"] == (1 if rule else 0),
                  f"small spec {dev} {name}: recoveries")
    ref = streams["cpu", "spec_off"]
    for key, got in streams.items():
        for i, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                continue
            pos = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            with torch.no_grad():
                logits = tllama.forward_pure(
                    cfg, params, torch.tensor([prompts[i] + b[:pos]]))[0][
                        0, -1]
            top = torch.topk(logits, 2).values
            raise RuntimeError(
                f"check failed: small spec {key}: request {i} differs from "
                f"the CPU's spec-off stream at token {pos} ({a[pos]} vs "
                f"{b[pos]}); the CPU's top-2 logit margin there is "
                f"{(top[0] - top[1]).item():.3g}")
    acc = {k: (v["spec_accepted"], v["spec_proposed"])
           for k, v in stats.items()}
    check(all(a > 0 for (dev, n), (a, p) in acc.items() if n != "spec_off"),
          f"small spec: no draft accepted: {acc}")
    print(f"small spec check (f32, dense weights): 8 runs (cpu, cuda) x "
          f"(spec off, spec k=3, spec + prefix, spec + prefix + a failed "
          f"step) give the same {sum(map(len, ref))} tokens; accepted / "
          f"proposed {acc}")


# the fleet runs: (name, chaos rule or None, router step after which
# replica b is drained or None, the router's step_timeout_s or None).
# The hang sleeps 2 s on the host in replica a's 4th step, past the
# router's 1 s budget (run_with_deadline), with no engine watchdog
FLEET_RUNS = (("clean", None, None, None),
              ("kill", "kill@serve.replica.a.step:step=3", None, None),
              ("drain", None, 4, None),
              ("hang", "hang@serve.step:step=3,times=1,secs=2", None, 1.0))
# what the scraped /metrics is held to: serving_stats() key -> the series
# counting it (summed over its label sets; a series never created is 0)
STAT_SERIES = {
    "prefill_tokens": "serve_prefill_tokens_total",
    "decode_tokens": "serve_decode_tokens_total",
    "requests_finished": "serve_request_latency_seconds_count",
    "requests_preempted": "serve_preemptions_total",
    "prefix_hit_tokens": "serve_prefix_hit_tokens_total",
    "shed": "serve_shed_total", "cancelled": "serve_cancelled_total",
    "recoveries": "serve_recoveries_total",
    "quarantined": "serve_quarantined_total",
    "deadline_expired": "serve_deadline_expired_total",
    "failovers": "serve_failovers_total",
    "replicas_dead": "serve_replica_dead_total",
    "drains": "serve_drains_total"}
FLEET_TRACE_DIR = "chiprun_out/fleet_trace"


def scrape(port, path):
    """GET one exporter endpoint over 127.0.0.1; (status, body)."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def prom_sums(text):
    """Prometheus text -> {series name: value summed over label sets}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            name = name.split("{")[0]
            out[name] = out.get(name, 0.0) + float(value)
    return out


class Scraper:
    """A second thread scraping /metrics, /healthz and /slo every 50 ms
    while the engines step (what a monitoring agent does)."""

    def __init__(self, port):
        import threading
        self.port, self.scrapes, self.errors = port, 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(0.05):
            try:
                for path in ("/metrics", "/healthz", "/slo"):
                    status, _ = scrape(self.port, path)
                    check(status == 200, f"{path} answered {status}")
                self.scrapes += 1
            except Exception as exc:  # noqa: BLE001 — reported below
                self.errors.append(repr(exc))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        check(not self._thread.is_alive(), "the scraper did not stop")


def fleet_run(torch, cfg, params, bench_serve, prompts, group, run, card):
    """One fleet run: fresh int8-KV engines ``a`` and ``b`` (prefix cache,
    max_running 8, chunk 8, pages of 16, speculation off) over the same
    weights behind one ``Router(locality_prefix=8)``, the bench's
    shared-prefix traffic (half up front, one more every other router
    step), metrics, trace and the exporter on, and the run's fault.
    Checks the books of every stream, the kernels' launches against
    both replicas' forwards, the scraped /metrics against
    ``serving_stats()``, the sidecar's request lifecycles against the
    engines' clock stamps and each live replica's service model."""
    import threading
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.profiler import exporter, metrics, trace
    from paddle_tpu_torch.runtime import watchdog
    from paddle_tpu_torch.serving import autoscale, router as router_mod
    from paddle_tpu_torch.testing import chaos
    name, rule, drain_at, timeout = run
    tag = f"fleet {name}"
    k = bench_serve.knobs()
    n_new, chunk = k["NEW"], k["CHUNK"]
    L = cfg.num_hidden_layers
    metrics.reset()
    trace.clear()
    serving.reset_stats()
    router_mod.reset_replica_stats()
    autoscale.reset_fleet_stats()
    watchdog.clear_incidents()
    engines = {n: serving.LLMEngine(
        cfg, params, device="cuda", max_running=8, chunk=chunk,
        page_size=k["PAGE"], max_model_len=k["PROMPT"] + n_new + chunk,
        kv_dtype="int8", prefix_cache=True) for n in ("a", "b")}
    wa, wb = (e.params["layers"]["wq"] for e in engines.values())
    check(isinstance(wa, dict) and wa["q"].data_ptr() == wb["q"].data_ptr(),
          f"{tag}: the replicas hold two copies of the weights")
    router = serving.Router(list(engines.items()), locality_prefix=8,
                            step_timeout_s=timeout)
    exp = exporter.active()
    check(exp is not None and exp.host == "127.0.0.1" and exp.port > 0,
          f"{tag}: the exporter did not start on 127.0.0.1")
    delivered = {}

    def on_tok(gid, tok, done):
        delivered.setdefault(gid, []).append(tok)

    scraper = Scraper(exp.port)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bench_serve.reset_kernel_launches()
    half = len(prompts) // 2
    t0 = time.monotonic()
    gids = [router.submit(p, n_new, on_token=on_tok) for p in prompts[:half]]
    pending = list(prompts[half:])
    steps = drained = 0
    with chaos.installed(chaos.Chaos(rule or "")) as c:
        while router.has_work() or pending:
            if pending and steps % 2 == 1:
                gids.append(router.submit(pending.pop(0), n_new,
                                          on_token=on_tok))
            router.step()
            steps += 1
            if steps == drain_at:
                drained = router.drain("b")
                check(not engines["b"].has_work(), f"{tag}: b kept work")
            check(steps < 2000, f"{tag}: the router did not converge")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    # a step abandoned at its deadline runs on to its end: every count
    # is read after it
    for t in threading.enumerate():
        if t.name.startswith("ptq-deadline-"):
            t.join(timeout=120)
            check(not t.is_alive(), f"{tag}: an abandoned step never ended")
    torch.cuda.synchronize()
    launches = bench_serve.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    scraper.stop()
    stats = serving.serving_stats()
    states = router.replica_states()
    if rule:
        check(len(c.log) >= 1, f"{tag}: the fault never fired")

    # every stream: all its tokens, each delivered once
    for g in gids:
        check(router.is_finished(g) and router.error_of(g) is None,
              f"{tag}: gid {g} did not finish")
        check(delivered.get(g) == router.output_of(g)
              and len(delivered[g]) == n_new, f"{tag}: gid {g} delivered "
              f"{len(delivered.get(g, []))} tokens for {n_new}")
    fw = [e.forwards for e in engines.values()]
    check(all(f["probe"] == f["mirror"] == f["propose"] == 0 for f in fw),
          f"{tag}: forwards {fw}")
    check_launches(launches, fw, L, True, tag)
    check(launches["ragged_paged_attention"] == 0,
          f"{tag}: row 11 ran over int8 pools")
    evs = trace.events()
    places = [e for e in evs if e["name"] == "route/place"]
    migrations = sum(router._requests[g].migrations for g in gids)
    # the tokens each failed-over stream had delivered: what its survivor
    # re-prefilled after the prompt
    moved_at = [e["delivered"] for e in evs if e["name"] == "route/failover"]
    if name == "clean":
        check(states == {"a": "live", "b": "live"}, f"{tag}: {states}")
        first = {}
        for e in places:
            if e["migration"] == 0:
                first.setdefault(group[gids.index(e["gid"])],
                                 set()).add(e["replica"])
        check(all(len(v) == 1 for v in first.values()),
              f"{tag}: a system prompt's requests spread over replicas "
              f"{first}")
    elif name in ("kill", "hang"):
        check(states == {"a": "dead", "b": "live"}, f"{tag}: {states}")
        check(stats["replicas_dead"] == 1 and stats["failovers"] >= 1,
              f"{tag}: {stats['replicas_dead']} dead, "
              f"{stats['failovers']} failovers")
        check(engines["b"].kv.audit()["ok"], f"{tag}: b's books "
              f"{engines['b'].kv.audit()}")
        if name == "hang":
            rec = [r for r in watchdog.incidents()
                   if r["kind"] == "watchdog_expired"]
            check(rec and rec[-1]["phase"] == "serve.replica.a",
                  f"{tag}: no run_with_deadline expiry: {rec}")
    else:
        check(states == {"a": "live", "b": "draining"}, f"{tag}: {states}")
        cut = next(i for i, e in enumerate(evs)
                   if e["name"] == "route/drain")
        late = [e for e in evs[cut:] if e["name"] == "route/place"]
        check(drained >= 1 and late and all(e["replica"] == "a"
                                             for e in late),
              f"{tag}: {drained} migrated; placed after the drain: "
              f"{[e['replica'] for e in late]}")
        check(stats["drains"] == 1, f"{tag}: {stats['drains']} drains")
    for n, e in engines.items():
        if states[n] != "dead":
            check(e.kv.audit()["ok"], f"{tag}: {n}'s books")

    # the scraped counters equal serving_stats(); the other endpoints
    status, body = scrape(exp.port, "/metrics")
    sums = prom_sums(body)
    bad = {key: (sums.get(series, 0.0), stats[key])
           for key, series in STAT_SERIES.items()
           if sums.get(series, 0.0) != stats[key]}
    check(status == 200 and not bad, f"{tag}: /metrics against "
          f"serving_stats(): {bad}")
    health = json.loads(scrape(exp.port, "/healthz")[1])
    check(health["router"]["replicas"] == states, f"{tag}: /healthz "
          f"{health.get('router')}")
    slo = json.loads(scrape(exp.port, "/slo")[1])
    check(slo["router"]["live_replicas"] == router.live_replicas()
          and len(slo["engines"]) == 2, f"{tag}: /slo {slo['router']}")
    check(not scraper.errors and scraper.scrapes >= 1, f"{tag}: "
          f"{scraper.scrapes} scrapes, errors {scraper.errors[:3]}")

    # the sidecar reads back, each request's lifecycle against its stamps
    out_dir = os.path.join(FLEET_TRACE_DIR, name)
    os.makedirs(out_dir, exist_ok=True)
    path = trace.write_sidecar(trace.sidecar_path(out_dir),
                               extra={"bench": "fleet", "run": name})
    header, side = trace.read_sidecar(path)
    check(header["dropped"] == 0 and len(side) == len(evs),
          f"{tag}: sidecar {len(side)} events of {len(evs)}, dropped "
          f"{header['dropped']}")
    by_rid = {}
    for e in side:
        if e.get("kind") == "request":
            by_rid.setdefault(e["rid"], []).append(e)
    for n, eng in engines.items():
        for rid, req in eng._requests.items():
            tl = by_rid.get(rid, [])
            first = {}
            for e in tl:
                first.setdefault(e["phase"], e["t"])
            terminal = sum(e["phase"] in trace.TERMINAL_PHASES for e in tl)
            check(terminal == 1 if states[n] != "dead" else terminal <= 1,
                  f"{tag}: request {rid} on {n} has {terminal} terminal "
                  f"events")
            check(first.get("queued") == req.arrival_s,
                  f"{tag}: request {rid} queued at {first.get('queued')}")
            if req.first_token_s is not None:
                queue = first["admitted"] - first["queued"]
                prefill = first["first_token"] - first["admitted"]
                check(abs(queue + prefill - (req.first_token_s
                                             - req.arrival_s)) < 1e-9,
                      f"{tag}: request {rid}: queue + prefill "
                      f"{queue + prefill} != TTFT "
                      f"{req.first_token_s - req.arrival_s}")

    # each replica's service model, from its own steps on the card
    tokens = sum(len(delivered[g]) for g in gids)
    offered = len(gids) / wall
    mean_prompt = sum(map(len, prompts)) // len(prompts)
    fleet = {}
    for n, eng in engines.items():
        measured = {b: len(eng._step_wall_s.get(b, [])) for b in (1, chunk)}
        sm = eng.service_model()
        if states[n] == "live":
            check(sm.calibrated and all(measured.values()),
                  f"{tag}: {n}'s service model lacks a measured bucket "
                  f"({measured}); it would print the placeholders")
        elif not all(measured.values()):
            fleet[n] = {"calibrated": False, "steps_measured": measured}
            continue
        fleet[n] = {
            "calibrated": sm.calibrated, "steps_measured": measured,
            "decode_step_ms": 1e3 * sm.decode_step_s,
            "prefill_chunk_ms": 1e3 * sm.prefill_chunk_s,
            "concurrency": sm.concurrency,
            "capacity_rps": sm.capacity_rps(mean_prompt, n_new),
            "replicas_for_offered": autoscale.replicas_for(
                sm, offered, prompt_len=mean_prompt, new_tokens=n_new)}
    reqs = [router._requests[g] for g in gids]
    ttft = [1e3 * (r.first_token_s - r.arrival_s) for r in reqs]
    res = dict(tokens_per_s=tokens / wall, wall_s=wall, tokens=tokens,
               ttft_p50_ms=float(np.percentile(ttft, 50)),
               ttft_p95_ms=float(np.percentile(ttft, 95)),
               router_steps=steps, failovers=int(stats["failovers"]),
               migrations=migrations, delivered_at_failover=moved_at,
               drained=drained, states=states,
               max_memory_allocated=peak,
               pool_bytes=engines["a"]._pool_bytes, launches=launches,
               forwards={n: dict(e.forwards) for n, e in engines.items()},
               offered_rps=offered, fleet=fleet, scrapes=scraper.scrapes,
               sidecar=path, events=len(evs))
    print(f"{tag} [{card}]: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s, TTFT p50 {res['ttft_p50_ms']:.2f}"
          f" ms p95 {res['ttft_p95_ms']:.2f} ms, {steps} router steps, "
          f"{res['failovers']} failovers ({moved_at} tokens delivered "
          f"before each), {migrations} migrations, "
          f"{drained} drained, states {states}, max_memory_allocated "
          f"{peak} bytes, launches {launches}, forwards {res['forwards']}, "
          f"{scraper.scrapes} scrapes, sidecar {path} ({len(evs)} events)")
    for n, f in fleet.items():
        print(f"{tag} [{card}]: replica {n} fleet block {json.dumps(f)} "
              f"(offered {offered:.3f} rps)")
    for e in engines.values():
        e.shutdown()
    streams = [router.output_of(g) for g in gids]
    exporter.shutdown()
    return res, streams


def fleet_phase(torch, tllama, bench_serve, params, card):
    """The serving stack's fleet at llama7b on the card: two replicas of
    the bench's shared-prefix engine (int8 weights shared, int8 KV)
    behind one router, with metrics, the flight recorder and the live
    exporter on, four times on fresh engines: clean, a replica killed at
    its 4th router step, replica b drained after router step 4, and a
    replica step hung past the router's 1 s budget.  Returns the runs."""
    from paddle_tpu_torch import flags
    cfg = tllama.preset("llama7b")
    k = bench_serve.knobs()
    prompts, heads, _ = bench_serve.prompts_for("shared-prefix", k,
                                                cfg.vocab_size)
    group = [next(i for i, h in enumerate(heads) if p[:len(h)] == h)
             for p in prompts]
    flags.set_flags({"FLAGS_tpu_metrics": True, "FLAGS_tpu_trace": True,
                     "FLAGS_tpu_metrics_port": -1})
    runs, streams = {}, {}
    try:
        for run in FLEET_RUNS:
            runs[run[0]], streams[run[0]] = fleet_run(
                torch, cfg, params, bench_serve, prompts, group, run, card)
    finally:
        flags.set_flags({"FLAGS_tpu_metrics": False,
                         "FLAGS_tpu_trace": False,
                         "FLAGS_tpu_metrics_port": 0})
    clean = streams["clean"]
    total = sum(map(len, clean))
    for name in ("kill", "drain", "hang"):
        same = sum(a == b for x, y in zip(streams[name], clean)
                   for a, b in zip(x, y))
        whole = sum(x == y for x, y in zip(streams[name], clean))
        runs[name]["tokens_equal_clean"] = same
        runs[name]["streams_equal_clean"] = whole
        print(f"fleet {name} [{card}]: tokens equal to the clean run's "
              f"{same}/{total}, streams {whole}/{len(clean)} (not gated: a "
              f"failed-over stream re-prefills prompt + delivered in Tc = 8 "
              f"chunks where it decoded at Tc = 1; bf16/int8 tiles sum in "
              f"other orders and random weights' margins are tiny)")
    return runs


def small_router_check(torch, tllama, serving, chaos):
    """Failover's streams on the card against the CPU: a small float32
    model (``small_spec_check``'s), 8 requests over 2 system prompts,
    served by two replicas on the card behind a router whose replica a
    is killed at its 7th step (streams mid-decode fail over to b as
    prompt + delivered), against one uninterrupted engine on the CPU;
    over float32 pages (row 11) and int8 pages (row 12).  Every stream
    equal token for token, each token delivered once."""
    cfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, quantized="off")
    params = tllama.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(4)
    heads = [[int(t) for t in rng.randint(1, 512, n)] for n in (21, 13)]
    prompts = [heads[i % 2] + [int(t) for t in rng.randint(1, 512, 2 + i)]
               for i in range(8)]
    n_new = 12
    for kv in (None, "int8"):
        def engine(dev):
            return serving.LLMEngine(cfg, params, device=dev, max_running=4,
                                     chunk=8, page_size=16, max_model_len=64,
                                     kv_dtype=kv)

        ref_eng = engine("cpu")
        rids = [ref_eng.add_request(p, n_new) for p in prompts]
        ref_eng.run()
        ref = [ref_eng.output_of(r) for r in rids]
        serving.reset_stats()
        router = serving.Router([("a", engine("cuda")),
                                 ("b", engine("cuda"))])
        delivered = {}
        gids = [router.submit(p, n_new, on_token=lambda g, t, d:
                              delivered.setdefault(g, []).append(t))
                for p in prompts]
        with chaos.installed(chaos.Chaos("kill@serve.replica.a.step:step=7")):
            out = router.run(max_steps=1000)
        moved = [router._requests[g] for g in gids
                 if router._requests[g].migrations]
        stats = serving.serving_stats()
        tag = f"small router ({kv or 'f32'} pages)"
        check(router.replica_states() == {"a": "dead", "b": "live"}
              and stats["failovers"] == len(moved) >= 1, f"{tag}: "
              f"{router.replica_states()}, {stats['failovers']} failovers")
        for i, g in enumerate(gids):
            check(out[g] == ref[i] and delivered[g] == ref[i],
                  f"{tag}: stream {i} differs from the CPU's uninterrupted "
                  f"stream: {out[g]} vs {ref[i]}")
        print(f"{tag}: 8 streams on the card behind a router, replica a "
              f"killed at step 7, {len(moved)} failed over to b, equal to "
              f"the CPU's uninterrupted streams ({sum(map(len, ref))} "
              f"tokens, each delivered once)")


def instrumentation_us(flags, metrics, trace, calls=20000):
    """Host microseconds a call of each instrumentation primitive the
    engine's step runs, with its flag on: a request event, a span, a
    counter, a gauge and a histogram update; and with the flags off,
    what the step pays instead: the trace calls themselves (each returns
    at its flag) and ``metrics.enabled()``, which guards every metric
    update of the engine."""
    off = {
        "request_event": lambda i: trace.request_event("decode", i, t=0.0,
                                                       tokens=1),
        "span": lambda i: trace.span("serve/step", step=i).__enter__()
        .__exit__(None, None, None),
        "metrics_enabled": lambda i: metrics.enabled(),
    }
    prims = {
        "request_event": lambda i: trace.request_event("decode", i, t=0.0,
                                                       tokens=1),
        "span": lambda i: trace.span("serve/step", step=i).__enter__()
        .__exit__(None, None, None),
        "counter": lambda i: metrics.counter(
            "serve_decode_tokens_total", "Decode tokens generated").inc(1),
        "gauge": lambda i: metrics.gauge(
            "serve_queue_depth", "Requests waiting for admission").set(i),
        "histogram": lambda i: metrics.histogram(
            "serve_ttft_seconds", "Time to first token").observe(1e-3 * i),
    }
    out = {}
    for on in (True, False):
        flags.set_flags({"FLAGS_tpu_metrics": on, "FLAGS_tpu_trace": on})
        for name, fn in (prims if on else off).items():
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            out[f"{name}_{'on' if on else 'off'}"] = (
                1e6 * (time.perf_counter() - t0) / calls)
    flags.set_flags({"FLAGS_tpu_metrics": False, "FLAGS_tpu_trace": False})
    metrics.reset()
    trace.clear()
    return out


OBS_TURNS = (False, True, True, False)


def obs_cost_phase(torch, bench_serve, params, card):
    """What metrics and the flight recorder cost a user of the card: the
    bench's bf16-KV serve run at llama7b with ``FLAGS_tpu_metrics`` and
    ``FLAGS_tpu_trace`` off and on, in turns off, on, on, off in one
    call after one discarded warm-up run (medians a side), and the
    host cost of each instrumentation primitive.  The on-runs must
    record (series and events), the off-runs nothing."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.profiler import metrics, trace
    bench_serve.serve("cuda", kv_dtype="bf16", params=params)
    turns = []
    for on in OBS_TURNS:
        metrics.reset()
        trace.clear()
        flags.set_flags({"FLAGS_tpu_metrics": on, "FLAGS_tpu_trace": on})
        try:
            res = bench_serve.serve("cuda", kv_dtype="bf16",
                                    params=params).result
        finally:
            flags.set_flags({"FLAGS_tpu_metrics": False,
                             "FLAGS_tpu_trace": False})
        n_series, n_events = len(metrics.snapshot()), len(trace.events())
        check((n_series > 0 and n_events > 0) if on
              else (n_series == n_events == 0),
              f"obs cost: observability {on}: {n_series} series, "
              f"{n_events} events")
        turns.append(dict(on=on, tokens_per_s=res["value"],
                          decode_step_ms=res["decode_step_ms"],
                          prefill_step_ms=res["prefill_step_ms"],
                          ttft_p50_ms=res["ttft_p50_ms"], steps=res["steps"],
                          series=n_series, events=n_events))
        print(f"obs cost [{card}]: metrics + trace {'on ' if on else 'off'}:"
              f" {res['value']:.2f} tokens/s, decode step "
              f"{res['decode_step_ms']:.3f} ms, prefill step "
              f"{res['prefill_step_ms']:.3f} ms (means), TTFT p50 "
              f"{res['ttft_p50_ms']:.2f} ms, {n_series} series, {n_events} "
              f"events over {res['steps']} steps")
    out = {"turns": turns}
    for on in (False, True):
        side = [t for t in turns if t["on"] == on]
        out["on" if on else "off"] = {
            k: float(np.median([t[k] for t in side]))
            for k in ("tokens_per_s", "decode_step_ms", "prefill_step_ms")}
    out["host_us_per_call"] = instrumentation_us(flags, metrics, trace)
    on_turn = next(t for t in turns if t["on"])
    out["events_per_step"] = on_turn["events"] / on_turn["steps"]
    print(f"obs cost [{card}]: medians off {json.dumps(out['off'])}, on "
          f"{json.dumps(out['on'])}; host us a call "
          f"{json.dumps(out['host_us_per_call'])}; "
          f"{out['events_per_step']:.2f} trace events a step")
    return out


def profile_steps(torch, eng, prompts, card):
    """Where a step's time goes: 8 more requests served under
    torch.profiler; device time by kernel and the device's busy share of
    the profiled wall time (the profiler's own host cost inflates the
    wall, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.add_request(p, 8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    print_profile(prof, wall_us, f"profile [{card}]: {steps} steps", 10)


def prefill_profile(torch, serving, cfg, params, kv_dtype, card):
    """Where a chunk-64 prefill step of the long-context cell goes
    (``bench_serve`` with PROMPT=1024 CHUNK=64): an engine of that shape
    over the same weights, one warm-up request, then 8 fresh 1,024-token
    prompts whose first step (8 x 64 q rows, int8 GEMMs at M = 512) runs
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    chunk, prompt = 64, 1024
    eng = serving.LLMEngine(
        cfg, params, device="cuda", max_running=8, chunk=chunk,
        page_size=16, max_model_len=prompt + 2 * chunk,
        kv_dtype=None if kv_dtype == "bf16" else kv_dtype)
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, cfg.vocab_size, prompt))
               for _ in range(eng.max_running)]
    eng.add_request(prompts[0][:2 * chunk], 2)
    eng.run()
    before = len(eng._step_wall_s.get(chunk, []))
    for p in prompts:
        eng.add_request(p, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    check(len(eng._step_wall_s.get(chunk, [])) == before + 1,
          f"profile [{card}]: the profiled step was not a chunk-{chunk} "
          f"prefill")
    print_profile(prof, wall_us, f"profile [{card}]: one chunk-{chunk} "
                  f"prefill step, {len(prompts)} x {prompt}-token prompts",
                  10)
    del eng


# ---------------------------------------------------------------------------
# flash attention (the train path's kernels)
# ---------------------------------------------------------------------------

# (B, S, H, D): tails (S = 1, 17, 200, 257, 1000: no multiple of a tile;
# 257 one key past two 128-key tiles), both head dims, a long S at D = 64,
# GPT-2 small's call (12 heads of 64 at S = 1024, B = 8), the bench shape
# last
GPT2_FLASH = (8, 1024, 12, 64)
FLASH_CASES = [(1, 1, 2, 128), (2, 17, 3, 64), (1, 200, 2, 128),
               (1, 257, 2, 64), (1, 1000, 2, 128), (1, 4096, 4, 64),
               GPT2_FLASH, (4, 2048, 16, 128)]


def flash_bounds(B, S, H, D):
    """(bytes, ops) each flash function must move and do: every input read
    once and every output written once; the causal pairs only
    (S (S + 1) / 2 per head), 2 D ops per pair per matmul product (fwd
    2: s, p.v; the backward, dq, dk, dv from q, k, v, o, do, lse, 5: s,
    dp, p^T.do, ds^T.q, ds.k)."""
    x, rows = 2 * B * S * H * D, 4 * B * H * S
    pairs = B * H * S * (S + 1) // 2
    return {"fwd": (3 * x + x + rows, 4 * D * pairs),
            "bwd": (5 * x + rows + 3 * x, 10 * D * pairs)}


def rel_err(got, ref):
    """max |diff| / max |ref|, the scale floored at 1e-3: at S = 1 a row's
    softmax has one key, so dq and dk are exactly 0 and both sides hold
    rounding noise of ~1e-7."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-3)).item()


def rms_rel(got, ref, per_row):
    """RMS of the error over the reference's RMS (floored at 1e-3, for
    the exact zeros of S = 1): over each row of D and the worst row
    taken (``per_row``), or over the whole tensor.  Per row, a late
    query row of o, whose values are ~20x smaller than an early one's at
    S = 2048, is held to its own scale."""
    d, r = got.float() - ref.float(), ref.float()
    if per_row:
        return (d.pow(2).mean(-1).sqrt()
                / r.pow(2).mean(-1).sqrt().clamp_min(1e-3)).max().item()
    return (d.pow(2).mean().sqrt()
            / r.pow(2).mean().sqrt().clamp_min(1e-3)).item()


# per-row and whole-tensor RMS limits on o, dq, dk and dv: ~5x the
# kernels' readings, below a kernel that drops one far-diagonal k tile
# (``flash_control``)
ROW_REL_MAX, NORM_REL_MAX = 2e-2, 1e-2


def _attention_f32(torch, q, k, v, do, mask):
    """o, dq, dk, dv in f32 by autograd, the scores under ``mask``."""
    q, k, v = (t.float().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(q.shape[-1])
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v)
    return [o.detach(), *torch.autograd.grad(o, (q, k, v), do.float())]


def flash_control(torch, q, k, v, do):
    """The limits against a wrong kernel: attention that drops k tile 0
    (keys 0-63) for the last q tile only, a fault that only long S
    reaches, run in f32 and read against f32 causal attention.  It fails
    unless every one of o, dq, dk, dv breaks the per-row limit."""
    S = q.shape[1]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    wrong = causal.clone()
    wrong[S - 64:, :64] = False
    ref = _attention_f32(torch, q, k, v, do, causal)
    bad = _attention_f32(torch, q, k, v, do, wrong)
    names = ("o", "dq", "dk", "dv")
    row = {n: rms_rel(b, r, True) for n, b, r in zip(names, bad, ref)}
    norm = {n: rms_rel(b, r, False) for n, b, r in zip(names, bad, ref)}
    old = {n: ((b - r).abs().max().item() if n == "o" else rel_err(b, r))
           for n, b, r in zip(names, bad, ref)}
    print("flash control (k tile 0 dropped for the last q tile): row rel "
          + "  ".join(f"{n} {row[n]:.3g}" for n in names) + "; norm rel "
          + "  ".join(f"{n} {norm[n]:.3g}" for n in names)
          + "; o max |diff| / grad max-rel "
          + "  ".join(f"{n} {old[n]:.3g}" for n in names))
    for n in names:
        check(row[n] > ROW_REL_MAX, f"flash control: {n} row rel {row[n]} "
              f"passes the limit {ROW_REL_MAX}: the check cannot see a "
              f"dropped tile")
    return row


def flash_inputs(torch, B, S, H, D):
    rng = np.random.RandomState(S + D)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(4)]


def flash_phase(torch, fa):
    """Each flash wrapper against its plain version (run in f32 on the same
    bf16 inputs): o max |diff| <= 2e-2 (bf16 output, values ~1); each
    gradient max |diff| / max |ref| <= 2e-2 (bf16 p and ds feed the
    tensor cores); lse max |diff| <= 1e-3; and o, dq, dk, dv each within
    ``ROW_REL_MAX`` per row and ``NORM_REL_MAX`` over the tensor
    (``rms_rel``).  Controlled at the bench shape, where a second
    backward must give the same bits; timed there, at D = 64 and at
    GPT-2 small's call (``GPT2_FLASH``)."""
    F = torch.nn.functional
    errs = {"fwd": 0.0, "bwd": 0.0}
    row_errs = {"fwd": 0.0, "bwd": 0.0}
    control = None
    for B, S, H, D in FLASH_CASES:
        q, k, v, do = flash_inputs(torch, B, S, H, D)
        o, lse = fa.flash_fwd(q, k, v)
        dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do)
        f32 = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = fa._flash_fwd_plain(*f32[:3])
        # the backward's reference runs on the kernel's own o and lse
        dq_ref, dk_ref, dv_ref = fa._flash_bwd_plain(
            *f32[:3], o.float(), lse, f32[3])
        torch.cuda.synchronize()
        e_o = (o.float() - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        e_g = {n: rel_err(g, r) for n, g, r in
               (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
        shape = f"B={B} S={S} H={H} D={D}"
        check(e_o <= 2e-2, f"flash_fwd {shape}: o max |diff| {e_o} > 2e-2")
        check(e_lse <= 1e-3, f"flash_fwd {shape}: lse max |diff| {e_lse}")
        for n, e in e_g.items():
            check(e <= 2e-2, f"flash_bwd {shape}: {n} rel err {e} > 2e-2")
        got = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref),
               "dv": (dv, dv_ref)}
        e_row = {n: rms_rel(g, r, True) for n, (g, r) in got.items()}
        e_norm = {n: rms_rel(g, r, False) for n, (g, r) in got.items()}
        for n in got:
            check(e_row[n] <= ROW_REL_MAX, f"flash {shape}: {n} row rel "
                  f"{e_row[n]} > {ROW_REL_MAX}")
            check(e_norm[n] <= NORM_REL_MAX, f"flash {shape}: {n} norm rel "
                  f"{e_norm[n]} > {NORM_REL_MAX}")
        for key, ns in (("fwd", ("o",)), ("bwd", ("dq", "dk", "dv"))):
            row_errs[key] = max([row_errs[key]] + [e_row[n] for n in ns])
        errs["fwd"] = max(errs["fwd"], e_o)
        errs["bwd"] = max([errs["bwd"]] + [(g.float() - r).abs().max().item()
                                           for g, r in ((dq, dq_ref),
                                                        (dk, dk_ref),
                                                        (dv, dv_ref))])
        print(f"flash {shape}: o {e_o:.3g}  lse {e_lse:.3g}  rel dq "
              f"{e_g['dq']:.3g} dk {e_g['dk']:.3g} dv {e_g['dv']:.3g}; row "
              "rel " + "  ".join(f"{n} {e_row[n]:.3g}" for n in got)
              + "; norm rel " + "  ".join(f"{n} {e_norm[n]:.3g}"
                                          for n in got))
        del f32, o_ref, lse_ref, dq_ref, dk_ref, dv_ref, got
        if (B, S, H, D) == FLASH_CASES[-1]:
            control = flash_control(torch, q, k, v, do)
            # dq's key-tile parts are added in a fixed order: a second
            # call gives the same bits, as dk and dv (one writer each) do
            again = fa.flash_bwd(q, k, v, o, lse, do)
            check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                  f"flash_bwd {shape}: a second call differs")
            print(f"flash bwd {shape}: dq, dk, dv bit-identical over two "
                  f"calls")
    timing = {}
    B, S, H = FLASH_CASES[-1][:3]
    # the bench shape, its head dim halved, and GPT-2 small's call
    for key, shape in ((128, (B, S, H, 128)), (64, (B, S, H, 64)),
                       ("gpt2", GPT2_FLASH)):
        q, k, v, do = flash_inputs(torch, *shape)
        o, lse = fa.flash_fwd(q, k, v)
        timing[key] = flash_timing(torch, F, fa, q, k, v, do, o, lse)
        del q, k, v, do, o, lse
    return timing, errs, row_errs, control


def kernel_profile(torch, fn, calls):
    """Device ms a call of each kernel that ``calls`` calls of ``fn``
    launch, by torch.profiler: {kernel name: (ms a call, launches a
    call)}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in device_rows(prof)}


def flash_timing(torch, F, fa, q, k, v, do, o, lse):
    """Graph-replayed ms a call of the forward and the backward, their
    plain versions, SDPA's forward and backward, the bounds, and the
    backward's launches by kernel.  Takes the module, so another
    package's flash functions can run through the same timing."""
    B, S, H, D = q.shape
    shape = f"B={B} S={S} H={H} D={D}"

    def bwd(i):
        return fa.flash_bwd(q, k, v, o, lse, do)

    ms = {"fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v), calls=20),
          "bwd": time_ms(torch, bwd, calls=20)}
    plain = {
        "fwd": time_ms(torch, lambda i: fa._flash_fwd_plain(q, k, v),
                       calls=2, replays=2),
        "bwd": time_ms(torch, lambda i: fa._flash_bwd_plain(
            q, k, v, o, lse, do), calls=2, replays=2),
    }
    # yardstick: SDPA on [B, H, S, D], timed as the kernels are (CUDA-graph
    # replay); its backward is its forward + backward less its forward
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib = {"fwd": time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), calls=20)}
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

    def fwd_bwd(i):
        y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(y, (qg, kg, vg), dot)

    lib["fwd_bwd"] = time_ms(torch, fwd_bwd, calls=10)
    lib["bwd"] = lib["fwd_bwd"] - lib["fwd"]
    bounds = {n: bound_ms(*flash_bounds(B, S, H, D)[n], "bf16")
              for n in ("fwd", "bwd")}
    for n in ("fwd", "bwd"):
        print(f"flash {n} {shape}: kernel {ms[n]:.4f} ms  plain "
              f"{plain[n]:.4f} ms  sdpa {lib[n]:.4f} ms  bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]})")
    profile = kernel_profile(torch, lambda: bwd(0), calls=10)
    for name, (k_ms, n) in sorted(profile.items(), key=lambda x: -x[1][0]):
        print(f"flash bwd {shape}: profile {k_ms:.4f} ms a call, {n:g} x  "
              f"{name[:90]}")
    print(f"flash fwd+bwd {shape}: kernels {ms['fwd'] + ms['bwd']:.4f} ms"
          f"  sdpa {lib['fwd_bwd']:.4f} ms")
    out = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bounds": bounds,
           "profile": {n: round(m, 5) for n, (m, _) in profile.items()}}
    del qt, kt, vt, dot, qg, kg, vg
    return out


# ---------------------------------------------------------------------------
# the fused decoder blocks (the train path's kernels at the default policy)
# ---------------------------------------------------------------------------

# the bench step's shape: B, S, H, head dim, intermediate
FUSED_SHAPE = (4, 2048, 2048, 128, 5632)
EPS = 1e-6


def fused_inputs(torch, B, S, H, D, I):
    """Random bf16 operands at the bench's scales: activations and the
    output gradient N(0, 1), weights N(0, 0.02) as ``init_params``
    draws them, ln 1 + N(0, 0.1); the bench's rope tables."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    half = D // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, device=dev).float() / half))
    ang = torch.arange(S, device=dev).float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    return dict(x=rnd(B, S, H), dy=rnd(B, S, H),
                ln=(1 + 0.1 * torch.randn(H, generator=g, device=dev)).to(
                    torch.bfloat16),
                wq=rnd(H, H, scale=0.02), wk=rnd(H, H, scale=0.02),
                wv=rnd(H, H, scale=0.02), wo=rnd(H, H, scale=0.02),
                wg=rnd(H, I, scale=0.02), wu=rnd(H, I, scale=0.02),
                wd=rnd(I, H, scale=0.02), sin=emb.sin(), cos=emb.cos())


def fused_bounds(B, S, H, D, I):
    """(bytes, ops) of each fused function: inputs read and outputs
    written once (bf16 activations and weights, f32 tables and lse); the
    products' 2 operations per multiply-add, and the causal pairs of the
    attention (2 products, 2 D operations per pair each)."""
    M, x = B * S, 2 * B * S * H
    pairs = B * (H // D) * S * (S + 1) // 2
    return {
        "fused_qkv": (x + 2 * H + 3 * 2 * H * H + 2 * 4 * S * D + 3 * x,
                      3 * 2 * M * H * H),
        "fused_attn_epilogue": (4 * x + 2 * H * H + 2 * x
                                + 4 * B * (H // D) * S,
                                4 * D * pairs + 2 * M * H * H),
        "fused_mlp_fwd": (2 * x + 2 * H + 3 * 2 * H * I, 3 * 2 * M * H * I),
        "fused_mlp_bwd_dx": (3 * x + 2 * H + 3 * 2 * H * I,
                             5 * 2 * M * H * I),
    }


def gemm_products(H, I):
    """The GEMM launches of rows 7-10 by the name the profiler gives each
    (``gemm_tma_kernel<epilogue, B mode>`` by fused_blocks.cu's enums),
    with the K and N of its products over the M = B S rows: row 7's one
    launch runs q, k and v (grid z = 3: N = 3H), row 10's first da (N =
    I) and gate/up (N = 2I), both at K = H."""
    return {
        "fused_qkv": (
            ("q, k, v = xn [wq | wk | wv], rope on q and k",
             "gemm_tma_kernel<3, 0>", H, 3 * H),),
        "fused_attn_epilogue": (
            ("y = x + attn wo", "gemm_tma_kernel<0, 0>", H, H),),
        "fused_mlp_fwd": (
            ("gate/up, a = silu(g) u", "gemm_tma_kernel<1, 1>", H, 2 * I),
            ("down, y = x + a wd", "gemm_tma_kernel<0, 0>", I, H)),
        "fused_mlp_bwd_dx": (
            ("da = dy wd^T and gate/up, dg and du", "gate_up_grad_kernel",
             H, 3 * I),
            ("dxn = [dg | du] [wg | wu]^T", "gemm_tma_kernel<2, 2>", 2 * I,
             H)),
    }


def fused_compositions(torch, fb, t, D):
    """The unfused PyTorch composition of each block on the same bf16
    operands: cuBLAS bf16 matmuls, elementwise ops and, for the
    attention, SDPA.  A yardstick of speed only; the port never calls
    them."""
    F = torch.nn.functional
    B, S, H = t["x"].shape
    nh = H // D

    def rms(x):
        return fb._rms_norm(x, t["ln"], EPS)

    def qkv():
        xn = rms(t["x"])
        return (fb._rope_flat(xn @ t["wq"], t["sin"], t["cos"], D),
                fb._rope_flat(xn @ t["wk"], t["sin"], t["cos"], D),
                xn @ t["wv"])

    q, k, v = (z.view(B, S, nh, D).transpose(1, 2).contiguous()
               for z in qkv())

    def attn():
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return t["x"] + o.transpose(1, 2).reshape(B, S, H) @ t["wo"]

    def mlp():
        xn = rms(t["x"])
        return t["x"] + (F.silu(xn @ t["wg"]) * (xn @ t["wu"])) @ t["wd"]

    def dx():
        x, dy = t["x"], t["dy"]
        xn = rms(x)
        g, u = xn @ t["wg"], xn @ t["wu"]
        da = dy @ t["wd"].t()
        sg = torch.sigmoid(g)
        dg = da * u * (sg + g * sg * (1 - sg))
        du = da * g * sg
        dz = (dg @ t["wg"].t() + du @ t["wu"].t()).float() * t["ln"].float()
        x32 = x.float()
        r = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + EPS)
        inner = (dz * x32).sum(-1, keepdim=True)
        return (dy.float() + dz * r - x32 * (inner * r ** 3 / H)).to(x.dtype)

    return {"fused_qkv": qkv, "fused_attn_epilogue": attn,
            "fused_mlp_fwd": mlp, "fused_mlp_bwd_dx": dx}


def fused_controls(fb, t, D, refs):
    """The limits against a wrong kernel: each plain version with one
    block of its sum dropped, read against the plain version.  qkv: the
    last 32 rows of K (one k step of the GEMM) left out of the q
    projection; attention: the last head's term left out of y's sum over
    heads; MLP: the last 128 columns of I (one N tile) left out of the
    down product; dx: the last 128 columns of I left out of the dx sum.
    Each must break the per-row limit."""
    x, ln = t["x"], t["ln"]
    dt = x.dtype
    xn = fb._rms_norm(x, ln, EPS)
    q = fb._rope_flat(fb._mm32(xn[..., :-32], t["wq"][:-32]).to(dt),
                      t["sin"], t["cos"], D)
    attn = refs["fused_attn_epilogue"][1]
    y_attn = (x.float() + fb._mm32(attn[..., :-D], t["wo"][:-D])).to(dt)
    keep = t["wg"].shape[1] - 128
    y_mlp = fb._fused_mlp_fwd_plain(x, ln, t["wg"][:, :keep],
                                    t["wu"][:, :keep], t["wd"][:keep], EPS)
    dx = fb._fused_mlp_bwd_dx_plain(x, ln, t["wg"][:, :keep],
                                    t["wu"][:, :keep], t["wd"][:keep],
                                    t["dy"], EPS)
    bad = {"fused_qkv": (q, refs["fused_qkv"][0]),
           "fused_attn_epilogue": (y_attn, refs["fused_attn_epilogue"][0]),
           "fused_mlp_fwd": (y_mlp, refs["fused_mlp_fwd"]),
           "fused_mlp_bwd_dx": (dx, refs["fused_mlp_bwd_dx"])}
    row = {n: rms_rel(b, r, True) for n, (b, r) in bad.items()}
    print("fused controls (one block of each sum dropped): row rel "
          + "  ".join(f"{n} {e:.3g}" for n, e in row.items()))
    for n, e in row.items():
        check(e > ROW_REL_MAX, f"fused control {n}: row rel {e} passes the "
              f"limit {ROW_REL_MAX}: the check cannot see a dropped block")
    return row


def fused_phase(torch, fb):
    """Each fused-block kernel against its plain version at the bench
    shape, on the same bf16 inputs: the plain versions follow the
    kernels' rounding (f32 products, bf16 casts where the kernels cast),
    so they differ by summation order and, in dx, by the bf16 rounding
    of dg and du before the tensor cores.  Every output within
    ``ROW_REL_MAX`` per row and ``NORM_REL_MAX`` over the tensor, lse
    within 1e-3; a control per kernel (``fused_controls``) must break
    the row limit.  Times by CUDA-graph replay: kernel, plain, bound and
    the unfused composition; each call's launches by kernel (device ms a
    call from torch.profiler), so row 8's flash and GEMM halves and the
    GEMMs of rows 7, 9 and 10 are seen apart, and each GEMM launch of
    rows 7-10 with its TFLOP/s and share of the card's peak
    (``gemm_products``; a launch missing from the profile fails)."""
    B, S, H, D, I = FUSED_SHAPE
    t = fused_inputs(torch, B, S, H, D, I)
    args = {
        "fused_qkv": lambda: fb.fused_qkv(
            t["x"], t["ln"], t["wq"], t["wk"], t["wv"], t["sin"], t["cos"],
            head_dim=D, eps=EPS),
        "fused_mlp_fwd": lambda: fb.fused_mlp_fwd(
            t["x"], t["ln"], t["wg"], t["wu"], t["wd"], eps=EPS),
        "fused_mlp_bwd_dx": lambda: fb.fused_mlp_bwd_dx(
            t["x"], t["ln"], t["wg"], t["wu"], t["wd"], t["dy"], eps=EPS),
    }
    plain = {
        "fused_qkv": lambda: fb._fused_qkv_plain(
            t["x"], t["ln"], t["wq"], t["wk"], t["wv"], t["sin"], t["cos"],
            D, EPS),
        "fused_mlp_fwd": lambda: fb._fused_mlp_fwd_plain(
            t["x"], t["ln"], t["wg"], t["wu"], t["wd"], EPS),
        "fused_mlp_bwd_dx": lambda: fb._fused_mlp_bwd_dx_plain(
            t["x"], t["ln"], t["wg"], t["wu"], t["wd"], t["dy"], EPS),
    }
    got = {n: f() for n, f in args.items()}
    refs = {n: f() for n, f in plain.items()}
    # the attention epilogue runs on the kernel's own q, k, v
    q, k, v = got["fused_qkv"]
    args["fused_attn_epilogue"] = lambda: fb.fused_attn_epilogue(
        q, k, v, t["x"], t["wo"], head_dim=D)
    plain["fused_attn_epilogue"] = lambda: fb._fused_attn_epilogue_plain(
        q, k, v, t["x"], t["wo"], D)
    got["fused_attn_epilogue"] = args["fused_attn_epilogue"]()
    refs["fused_attn_epilogue"] = plain["fused_attn_epilogue"]()
    torch.cuda.synchronize()
    names = ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
             "fused_mlp_bwd_dx")
    res = {}
    for n in names:
        g, r = got[n], refs[n]
        pairs = {"fused_qkv": list(zip("qkv", g, r)),
                 "fused_attn_epilogue": [("y", g[0], r[0]),
                                         ("attn", g[1], r[1])],
                 "fused_mlp_fwd": [("y", g, r)],
                 "fused_mlp_bwd_dx": [("dx", g, r)]}[n]
        row = {o: rms_rel(a, b, True) for o, a, b in pairs}
        norm = {o: rms_rel(a, b, False) for o, a, b in pairs}
        err = max((a.float() - b.float()).abs().max().item()
                  for _, a, b in pairs)
        for o in row:
            check(row[o] <= ROW_REL_MAX, f"{n}: {o} row rel {row[o]} > "
                  f"{ROW_REL_MAX}")
            check(norm[o] <= NORM_REL_MAX, f"{n}: {o} norm rel {norm[o]} > "
                  f"{NORM_REL_MAX}")
        if n == "fused_attn_epilogue":
            e_lse = (g[2] - r[2]).abs().max().item()
            check(e_lse <= 1e-3, f"{n}: lse max |diff| {e_lse} > 1e-3")
        res[n] = dict(max_abs_err=err, row_rel_err=max(row.values()),
                      norm_rel_err=max(norm.values()))
        print(f"{n} B={B} S={S} H={H} D={D} I={I}: max |diff| {err:.3g}; "
              "row rel " + "  ".join(f"{o} {e:.3g}" for o, e in row.items())
              + "; norm rel " + "  ".join(f"{o} {e:.3g}"
                                          for o, e in norm.items()))
    control = fused_controls(fb, t, D, refs)
    del got, refs
    comp = fused_compositions(torch, fb, t, D)
    bounds = fused_bounds(B, S, H, D, I)
    products = gemm_products(H, I)
    from paddle_tpu_torch.bench import peak_bf16_flops
    peak = (peak_bf16_flops(torch.cuda.get_device_name(0))
            or PEAK_OPS_S["bf16"])
    for n in names:
        ms = time_ms(torch, lambda i: args[n](), calls=10)
        plain_ms = time_ms(torch, lambda i: plain[n](), calls=2, replays=2)
        comp_ms = time_ms(torch, lambda i: comp[n](), calls=10)
        b_ms, b_by = bound_ms(*bounds[n], "bf16")
        profile = kernel_profile(torch, args[n], calls=10)
        res[n].update(ms=ms, plain_ms=plain_ms, composition_ms=comp_ms,
                      bound_ms=b_ms, bound_by=b_by,
                      control_row_rel_err=control[n],
                      kernel_ms={kern: round(m, 5)
                                 for kern, (m, _) in profile.items()})
        print(f"{n}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"composition {comp_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        for kern, (k_ms, c) in sorted(profile.items(),
                                      key=lambda x: -x[1][0]):
            print(f"{n}: profile {k_ms:.4f} ms a call, {c:g} x  "
                  f"{kern[:90]}")
        for what, kern, K, N in products.get(n, ()):
            k_ms = [m for name, (m, _) in profile.items() if kern in name]
            check(len(k_ms) == 1, f"{n}: {len(k_ms)} launches of {kern} "
                  f"in the profile, expected 1 ({what})")
            tflops = 2 * B * S * K * N / k_ms[0] / 1e9
            res[n].setdefault("products", {})[what] = dict(
                ms=round(k_ms[0], 5), tflops=round(tflops, 1))
            print(f"{n}: product {what} (K {K}, N {N}): {k_ms[0]:.4f} ms, "
                  f"{tflops:.1f} TFLOP/s, {1e14 * tflops / peak:.1f} % of "
                  f"{peak / 1e12:g}")
    return res


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------

def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def small_train_check(torch, tllama, fused_blocks):
    """One train step's loss and gradients of a small model (head dim
    128, as many kv heads as heads, so that both fused blocks engage at
    "on"): the card in bf16 (the kernels, "dots" remat) against the CPU
    in f32 (the plain versions) on the same (bf16-valued) weights, at
    ``fused_blocks`` "on" or "off".  bf16 rounds every activation (8
    mantissa bits); the same comparison made on the CPU alone (bf16 vs
    f32) gives loss |diff| ~1e-4 and gradient errors ~1e-2 of each
    gradient's max, hence loss atol 1e-2 and gradient max |diff| /
    max |ref| <= 5e-2."""
    kw = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=128,
              remat_policy="dots", fused_blocks=fused_blocks)
    base = tllama.init_params(tllama.LlamaConfig(dtype=torch.bfloat16, **kw),
                              0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, 512, (2, 64))),
             "labels": torch.from_numpy(rng.integers(0, 512, (2, 64)))}
    outs = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        cfg = tllama.LlamaConfig(dtype=dtype, **kw)
        params = _tree(base, lambda t: t.to(dev, dtype).requires_grad_())
        modes = tllama._fused_block_modes(cfg, params["embed"])
        check(modes == ((fused_blocks == "on"),) * 2,
              f"small train step {fused_blocks} on {dev}: fused blocks "
              f"{modes}")
        total, ce = tllama.loss_fn(cfg, params, _tree(
            batch, lambda t: t.to(dev)))
        total.backward()
        outs[dev] = (ce.item(), {n: t.grad.float().cpu()
                                 for n, t in _flat(params).items()})
    loss_err = abs(outs["cpu"][0] - outs["cuda"][0])
    grad_err = max(rel_err(outs["cuda"][1][n], g)
                   for n, g in outs["cpu"][1].items())
    what = f"small train step (fused_blocks {fused_blocks})"
    check(math.isfinite(outs["cuda"][0]), f"{what}: loss not finite")
    check(loss_err <= 1e-2, f"{what}: loss |diff| {loss_err}")
    check(grad_err <= 5e-2, f"{what}: grad rel err {grad_err}")
    print(f"{what}, bf16 card vs f32 CPU: loss "
          f"{outs['cuda'][0]:.6f} vs {outs['cpu'][0]:.6f} (|diff| "
          f"{loss_err:.3g}, atol 1e-2), worst grad rel err {grad_err:.3g} "
          f"(<= 5e-2) over {len(outs['cpu'][1])} leaves")


def train_phase(torch, tbench, card, fused_blocks=None):
    """The train path: ``paddle_tpu_torch.bench.measure`` (the entry point
    of ``python -m paddle_tpu_torch.bench``) at bench.py's shape, 2
    warmup + 5 timed steps, every kernel launch counted.  At the default
    policy both fused blocks engage; at "off" the layer is unfused
    (the flash kernels alone)."""
    for w in tbench.KERNELS.values():
        w.launches = 0
    res = tbench.measure(iters=5, warmup=2, fused_blocks=fused_blocks)
    launches = {n: w.launches for n, w in tbench.KERNELS.items()}
    steps = res["iters"] + res["warmup"]
    L = tbench.MODEL["num_hidden_layers"]
    fwd = 2 * L if res["remat_policy"] != "none" else L
    fused = fused_blocks != "off"
    check(not res["oom_rungs"], f"a ladder rung ran out of memory: "
          f"{res['oom_rungs']}")
    check(res["fused_blocks"] == {"attention": fused, "mlp": fused},
          f"fused_blocks {fused_blocks}: the bench took {res['fused_blocks']}")
    per_step = {"flash_fwd": 0 if fused else fwd, "flash_bwd": L,
                "fused_qkv": fwd if fused else 0,
                "fused_attn_epilogue": fwd if fused else 0,
                "fused_mlp_fwd": fwd if fused else 0,
                "fused_mlp_bwd_dx": L if fused else 0}
    check(launches == {n: c * steps for n, c in per_step.items()},
          f"launches {launches} over {steps} steps, expected per step "
          f"{per_step} (remat {res['remat_policy']} recomputes each "
          f"forward kernel)")
    ln_v = math.log(tbench.MODEL["vocab_size"])
    check(all(math.isfinite(res[k]) for k in ("loss_step0", "loss_last")),
          "train loss not finite")
    check(abs(res["loss_step0"] - ln_v) <= 0.5,
          f"step-0 loss {res['loss_step0']} not within 0.5 of ln V {ln_v}")
    tag = "fused" if fused else "unfused"
    print(f"train {tag} [{card}]: {json.dumps(res)}")
    print(f"train {tag} [{card}]: step {res['step_ms']:.2f} ms, MFU "
          f"{res['value']:.2f} %, launches over {steps} steps {launches} = "
          f"per step {per_step}")
    return launches, res


# the train profile's classes, in order: a device row joins the first
# whose pattern its name matches (the port's kernels before the
# libraries', the optimizer's multi-tensor kernels before the rest of
# at::native); the rest is "other"
PROFILE_CLASSES = (
    ("port GEMMs", r"gemm_tma_kernel|gate_up_grad_kernel"),
    ("flash attention", r"flash_"),
    ("RMSNorm row passes", r"rms_norm"),
    ("cuBLAS GEMMs", r"nvjet|gemm|xmma|cutlass|cublas|splitKreduce"),
    ("optimizer", r"multi_tensor_apply|adam"),
    ("memcpy / memset", r"(?i)memcpy|memset"),
    ("elementwise / reduction", r"at::native|elementwise|reduce|CatArray"
                                r"|index|softmax|SoftMax"),
)


def step_gemm_flops(tbench, B, fused):
    """FLOPs of a train step's products by the class that runs them, from
    the shapes (M = B S rows, 2 a multiply-add; "dots" saves every matmul
    output, so no cuBLAS product is recomputed).  Unfused: every layer's
    q, k, v, o (K = N = H) and gate, up, down, and the lm_head, each
    forward, input and weight gradient.  Fused: cuBLAS runs the backward
    of ``fused_blocks``' two autograd Functions (attention: dwo, dy wo^T,
    and the prologue's forward, weight and input gradients, 11 of K = N =
    H; MLP: the composition's three forward products and six gradients,
    9 of H x I) and the lm_head's three; the port's kernels the rest,
    given per kernel name (row 8's and 9's residual GEMM shares one
    instantiation, launched equally often: its mean)."""
    m = tbench.MODEL
    H, I, V, L = (m["hidden_size"], m["intermediate_size"], m["vocab_size"],
                  m["num_hidden_layers"])
    M = B * tbench.SEQ
    hh, hi, head = 2 * M * H * H, 2 * M * H * I, 2 * M * H * V
    if not fused:
        return {"cuBLAS GEMMs": 3 * (L * (4 * hh + 3 * hi) + head)}, {}
    per_launch = {}
    for prods in gemm_products(H, I).values():
        for _, kern, K, N in prods:
            per_launch.setdefault(kern, []).append(2 * M * K * N)
    return ({"cuBLAS GEMMs": L * (11 * hh + 9 * hi) + 3 * head},
            {k: sum(v) / len(v) for k, v in per_launch.items()})


def busy_union_us(prof):
    """Device busy time from the trace: the union of the kernels' and
    copies' intervals, so launches that overlap count once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type != DeviceType.CPU
                   and not e.is_user_annotation)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_classes(prof, head, class_flops, kernel_flops,
                    classes=PROFILE_CLASSES):
    """Every device row summed into ``classes`` (``PROFILE_CLASSES``
    unless given; "other" printed with its largest names), each with its
    share of the busy time and, where ``class_flops`` gives its products,
    TFLOP/s; the port's GEMM kernels one by one with ``kernel_flops``
    (FLOPs a launch).  Fails unless the classes sum to the trace's busy
    time within 0.5 %."""
    rows = device_rows(prof)
    busy = busy_union_us(prof)
    names = [n for n, _ in classes] + ["other"]
    sums = {n: [0.0, 0, []] for n in names}
    for e in rows:
        cls = next((n for n, pat in classes if re.search(pat, e.key)),
                   "other")
        sums[cls][0] += e.self_device_time_total
        sums[cls][1] += e.count
        sums[cls][2].append(e)
    total = sum(v[0] for v in sums.values())
    print(f"{head}: device busy {busy / 1e3:.2f} ms (union of the trace's "
          f"intervals), classes sum {total / 1e3:.2f} ms")
    out = {}
    for n in names:
        us, count, evs = sums[n]
        line = (f"  {n:26s} {us / 1e3:9.3f} ms {100 * us / busy:5.1f} %  "
                f"{count:6d} launches")
        if n in class_flops and us > 0:
            line += (f"  {class_flops[n] / 1e12:.2f} TFLOP, "
                     f"{class_flops[n] / us / 1e6:.1f} TFLOP/s")
        print(line)
        out[n] = dict(ms=round(us / 1e3, 3), launches=count)
        if n == "other":
            for e in evs[:5]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.count:6d} x  {e.key[:90]}")
        if n == "port GEMMs":
            for e in evs:
                f = next((v for k, v in kernel_flops.items() if k in e.key),
                         None)
                rate = ("" if f is None else f"  {f * e.count / 1e12:.2f} "
                        f"TFLOP, {f * e.count / e.self_device_time_total / 1e6:.1f} "
                        "TFLOP/s")
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.count:6d} x  {e.key[:60]}{rate}")
    check(abs(total - busy) <= 5e-3 * busy, f"{head}: the classes sum to "
          f"{total / 1e3:.3f} ms, the trace's busy time is "
          f"{busy / 1e3:.3f} ms")
    return out


def train_profile(torch, tbench, tllama, card, fused_blocks=None):
    """Where a train step's time goes: one warmup step, then one step at
    ``fused_blocks`` (None: the default policy, the fused blocks) under
    torch.profiler at the bench's first rung; device time by kernel, the
    device's busy share of the profiled wall time, and every row summed
    into classes (``profile_classes``)."""
    from torch.profiler import ProfilerActivity, profile
    policy, B = tbench.LADDER[0]
    cfg = tllama.LlamaConfig(remat_policy=policy, fused_blocks=fused_blocks,
                             **tbench.MODEL)
    fused = fused_blocks != "off"
    check(tllama._fused_block_modes(cfg, torch.zeros(1, device="cuda"))
          == (fused, fused), f"the profiled step is not the "
          f"{'fused' if fused else 'unfused'} one")
    params = tllama.init_params(cfg, 0, device="cuda")
    for t in tbench.leaves(params):
        t.requires_grad_(True)
    opt = tbench.make_optimizer(params)
    batch = tbench.make_batch(cfg, B, tbench.SEQ, "cuda")
    tbench.train_step(cfg, params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tbench.train_step(cfg, params, opt, batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    head = f"profile train [{card}]: 1 {'fused' if fused else 'unfused'} step"
    print_profile(prof, wall_us, head, 20)
    classes = profile_classes(prof, head, *step_gemm_flops(tbench, B, fused))
    del params, opt
    return classes


def device_rows(prof):
    """The profile's kernels and copies with device time, longest first.
    Only these count: a CPU op's row repeats the device time of the
    kernels it launched, and a user annotation's device row
    (``Optimizer.step``) spans kernels that have rows of their own."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0),
                  key=lambda e: e.self_device_time_total, reverse=True)


def print_profile(prof, wall_us, head, top):
    """Device time by kernel and the busy share."""
    rows = device_rows(prof)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"{head}, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}% of wall)")
    for e in rows[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# the distributed train step (paddle_tpu_torch.distributed and
# models.llama.build_train_step): ranks as processes on the one card
# ---------------------------------------------------------------------------

# a 2-layer model the flash kernels take (bf16, head dim 64), the
# composition on every topology (fused_blocks "off") so that world size 1
# runs the same kernels as the tensor-parallel layer
DIST_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=256,
                  fused_blocks="off")
DIST_SMALL_SHAPE = (4, 128, 2)          # global batch, sequence, steps
DIST_SMALL_CASES = (("dp2xmp2", dict(dp=2, mp=2), {}),
                    ("dp2xsharding2", dict(dp=2, sharding=2), {}),
                    ("dp4_overlap", dict(dp=4), dict(overlap=True)))
# bf16 against world size 1 (the CPU tests' float32 tolerances do not
# apply: the flash kernels take bf16 only).  A loss moves by the
# summation order of bf16 partial sums, ~1e-3 of ln V; a parameter by
# at most 2 lr a step plus one bf16 step of its value (~2^-8 of it).
DIST_LOSS_ATOL = 2e-2      # the CPU's bf16 run of the small check: 1.8e-4
DIST_LR = 3e-4


def dist_batches(torch, vocab, B, S, steps, device):
    rng = np.random.default_rng(0)
    return [{"input_ids": torch.from_numpy(rng.integers(0, vocab, (B, S))
                                           ).to(device),
             "labels": torch.from_numpy(rng.integers(0, vocab, (B, S))
                                        ).to(device)}
            for _ in range(steps)]


def dist_small_rank(device, cases):
    """What each rank of ``small_dist_check`` runs (and world size 1 in
    the calling process): every case's train step from the same seed,
    with its losses, the gathered params and its own shards."""
    import torch
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.models import llama as tllama
    cfg = tllama.LlamaConfig(dtype=torch.bfloat16, **DIST_SMALL)
    B, S, steps = DIST_SMALL_SHAPE
    out = []
    for name, topo_kw, step_kw in cases:
        topo = init_mesh(**topo_kw)
        step, init = tllama.build_train_step(cfg, topo, device=device,
                                             **step_kw)
        params, opt = init(0)
        losses = []
        for b in dist_batches(torch, cfg.vocab_size, B, S, steps, device):
            losses.append(step(params, opt, topo.shard_batch(b))[2]["loss"]
                          .item())
        out.append(dict(
            name=name, losses=losses, coords=topo.coords,
            overlap=step.overlap,
            params=tllama._paths(tllama.gather_params(
                cfg, params, topo, virtual_pp=step.virtual_pp)),
            local={k: v.detach().float().cpu().numpy()
                   for k, v in tllama._paths(params).items()}))
    return out


def dist_param_check(got, ref, steps, what):
    """Each entry within 2 lr a step plus one bf16 step of the larger
    magnitude; returns the worst excess over 2 lr steps in bf16 steps."""
    worst = 0.0
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        ulp = np.maximum(np.abs(r), np.abs(got[k])) * 2.0 ** -8
        check(bool((d <= 2 * DIST_LR * steps + ulp).all()),
              f"{what}: {k} off by {float(d.max())}")
        worst = max(worst, float(((d - 2 * DIST_LR * steps) / np.maximum(
            ulp, 1e-30)).max()))
    return worst


def beside(*jobs):
    """Each job started on a thread of its own; returns their futures,
    in order (``.result()`` waits for one and raises what it raised).
    A job starts processes and waits for them (a gloo world's ranks, a
    launcher's pod, a bench or an example run) and runs nothing on the
    card in this process, so the kernels' counts, the current place and
    the flags that this process's phases set and read stay theirs while
    the caller goes on.  A gloo world or a pod on the one card spends
    most of its wall time starting processes and staging bytes through
    the host, so they overlap well: every rank measures its own
    allocator, losses, launches and collectives, which the overlap
    leaves as they are; their host-clock times are taken under it."""
    import concurrent.futures as cf
    ex = cf.ThreadPoolExecutor(len(jobs))
    futs = [ex.submit(job) for job in jobs]
    ex.shutdown(wait=False)
    return futs


def gloo_world(dist, fn, nprocs, args, device="cuda", timeout=600):
    """A job for ``beside``: ``dist.launch.spawn(fn, nprocs, args)`` over
    gloo (the ranks' results)."""
    return functools.partial(dist.launch.spawn, fn, nprocs, args,
                             device=device, backend="gloo", timeout=timeout)


def small_world_jobs(dist, device="cuda"):
    """``beside``'s jobs for the small checks' gloo worlds: one 4-rank
    world runs ``DIST_SMALL_CASES`` then ``PP_SMALL_CASES``, a 2-rank
    world ``CP_SMALL_CASES``."""
    return (gloo_world(dist, dist_small_rank, 4,
                       (device, DIST_SMALL_CASES + PP_SMALL_CASES), device),
            gloo_world(dist, dist_small_rank, 2, (device, CP_SMALL_CASES),
                       device))


def small_worlds(four, two, device="cuda"):
    """What ``small_dist_check`` and ``small_pp_check`` read: the small
    model's world-size-1 reference, run here once for both while the
    worlds run, and the ranks of ``small_world_jobs``'s worlds
    (``four``, ``two``: their futures)."""
    t0 = time.perf_counter()
    ref = dist_small_rank(device, [("ws1", {}, {})])[0]
    four, two = four.result(), two.result()
    n = len(DIST_SMALL_CASES)
    return dict(ref=ref, dist=[r[:n] for r in four],
                pp=[r[n:] for r in four], cp=two,
                seconds=time.perf_counter() - t0)


def small_dist_check(torch, dist, worlds):
    """The distributed step of a small bf16 model as 4 ranks on the one
    card over gloo (NCCL takes one rank a card): dp=2 x mp=2, dp=2 x
    sharding=2 (ZeRO over sharding) and dp=4 with the overlapped
    reduction, 2 steps each, held to the same model's world-size-1 step
    on the card (losses within ``DIST_LOSS_ATOL``, params by
    ``dist_param_check``); the ranks of one replica set hold the same
    bits.  ``worlds``: ``small_worlds``'s ranks."""
    ref, ranks = worlds["ref"], worlds["dist"]
    steps = DIST_SMALL_SHAPE[2]
    rows = {}
    for i, (name, _, step_kw) in enumerate(DIST_SMALL_CASES):
        res = [r[i] for r in ranks]
        err = max(abs(a - b) for r in res
                  for a, b in zip(r["losses"], ref["losses"]))
        check(err <= DIST_LOSS_ATOL, f"small dist {name}: losses "
              f"{res[0]['losses']} vs world size 1 {ref['losses']}")
        ulps = max(dist_param_check(r["params"], ref["params"], steps,
                                    f"small dist {name}") for r in res)
        by_mp = {}
        for r in res:
            by_mp.setdefault(r["coords"]["mp"], []).append(r["local"])
        for group in by_mp.values():
            for other in group[1:]:
                check(all(np.array_equal(other[k], v)
                          for k, v in group[0].items()),
                      f"small dist {name}: replicas differ")
        check(res[0]["overlap"] == bool(step_kw.get("overlap")),
              f"small dist {name}: overlap {res[0]['overlap']}")
        rows[name] = dict(losses=res[0]["losses"], loss_err=err,
                          param_excess_bf16_steps=ulps)
    print(f"small dist check (the small worlds {worlds['seconds']:.1f} s,"
          f" 4 ranks over gloo on one card, bf16): world size 1 losses "
          f"{ref['losses']}; " + json.dumps(rows))
    return rows


def dist_ws1_turn(torch, tbench, tllama, dist, kind, steps, warmup):
    """One turn of world size 1 at bench.py's shape: ``bench.train_step``
    or ``Plan().train_step`` (over the NCCL process group), warmup +
    ``steps`` timed steps; peak memory from after the params exist."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
    B = 4
    batch = tbench.make_batch(cfg, B, tbench.SEQ, dev)
    gc_cuda(torch)
    # what earlier phases of this process still hold: the turn's own
    # peak is the peak over it
    base = torch.cuda.memory_allocated(dev)
    if kind == "bench":
        params = tllama.init_params(cfg, 0, device=dev)
        for t in tbench.leaves(params):
            t.requires_grad_(True)
        opt = tbench.make_optimizer(params)

        def step():
            return tbench.train_step(cfg, params, opt, batch)
    else:
        step_fn, init_fn = dist.Plan().train_step(cfg, device=dev)
        params, opt = init_fn(0)

        def step():
            return step_fn(params, opt, batch)[2]["ce"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    launches0 = {n: w.launches for n, w in tbench.KERNELS.items()}
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    n_params = sum(t.numel() for t in tbench.leaves(params))
    res = dict(
        kind=kind, step_ms=1e3 * dt,
        mfu=100.0 * tbench.model_flops(n_params, B, tbench.SEQ, cfg) / dt
        / tbench.peak_bf16_flops(torch.cuda.get_device_name(dev)),
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        peak_over_base=torch.cuda.max_memory_allocated(dev) - base,
        losses=[float(x) for x in losses],
        launches_per_step={n: (w.launches - launches0[n]) / steps
                           for n, w in tbench.KERNELS.items()},
        weight_bytes=sum(t.numel() * t.element_size()
                         for t in tbench.leaves(params)))
    if kind == "bench":
        res["state_bytes"] = sum(v.numel() * v.element_size()
                                 for st in opt.state.values()
                                 for v in st.values()
                                 if torch.is_tensor(v) and v.dim() > 0)
    else:
        res["state_bytes"] = opt.state_bytes()
    del params, opt, step
    gc_cuda(torch)
    return res


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def dist_big_rank(topo_kw, steps):
    """What each rank of ``dist_train_phase``'s 2-rank worlds runs: the
    distributed step at bench.py's shape on this rank's rows, with its
    losses, step times, peak memory while ``init_fn`` draws the full
    params and after, what stays allocated once it returns (its shards
    only: the full draw is freed), the bytes of its weights and
    optimizer state, and its kernel launches."""
    import torch
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.models import llama as tllama
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig(remat_policy="dots", **big_model(tbench))
    topo = init_mesh(**topo_kw)
    step, init = tllama.build_train_step(cfg, topo, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params, opt = init(0)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated(dev)
    after_init = torch.cuda.memory_allocated(dev)
    batch = topo.shard_batch(tbench.make_batch(cfg, 4, tbench.SEQ, dev))
    for w in tbench.KERNELS.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(params, opt, batch)[2]["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(coords=topo.coords, losses=losses, step_ms=ms,
                init_max_memory_allocated=init_peak,
                memory_allocated_after_init=after_init,
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                weight_bytes=sum(t.numel() * t.element_size()
                                 for t in tbench.leaves(params)),
                state_bytes=opt.state_bytes(),
                launches={n: w.launches for n, w in tbench.KERNELS.items()})


# one turn each (the launches, bytes and loss bits are compared, not
# the times)
DIST_TURNS = ("bench", "dist")
# the 2-rank gloo worlds at bench.py's width (dist mp=2 / dp=2, pp=2,
# sp=2) run this many of its 16 layers, and so does their world-size-1
# reference (``ws1_losses``): depth, not width, is what is cut
BIG_LAYERS = 4


def big_model(tbench):
    return dict(tbench.MODEL, num_hidden_layers=BIG_LAYERS)
DIST_BIG = (("mp2", dict(mp=2)), ("dp2_zero", dict(dp=2)))


def dist_ws1_phase(torch, tbench, tllama, dist, card):
    """``dist_train_phase``'s first half, in this process: world size 1
    at bench.py's ~0.95B shape (S = 2048, B = 4, bf16, "dots", the fused
    blocks by the default policy) through ``Plan().train_step`` over an
    NCCL process group, in turns with ``bench.train_step``
    (``DIST_TURNS``, 2 warmup + 5 timed steps a turn): step ms, MFU,
    peak memory and kernel launches a step, which must equal the bench
    step's, and the losses, which must be the same bits (the same code
    runs).  Then world size 1 at the 2-rank worlds' depth
    (``ws1_losses``), their reference."""
    t0 = time.perf_counter()
    for w in tbench.KERNELS.values():
        w.launches = 0
    dist.init_parallel_env("cuda", world_size=1, rank=0)
    check(torch.distributed.get_backend() == "nccl",
          f"world size 1 runs over {torch.distributed.get_backend()}")
    torch.distributed.barrier()      # the NCCL communicator forms
    # (a world of one runs no collective in the step itself)
    turns = [dist_ws1_turn(torch, tbench, tllama, dist, kind, 5, 2)
             for kind in DIST_TURNS]
    dist.shutdown()
    ws1_launches = {n: w.launches for n, w in tbench.KERNELS.items()}
    print(f"dist train [{card}]: world size 1 turns {json.dumps(turns)}")
    bench_t = [t for t in turns if t["kind"] == "bench"]
    dist_t = [t for t in turns if t["kind"] == "dist"]
    for t in dist_t:
        check(t["launches_per_step"] == bench_t[0]["launches_per_step"],
              f"dist launches a step {t['launches_per_step']} vs bench "
              f"{bench_t[0]['launches_per_step']}")
        check(t["losses"] == bench_t[0]["losses"],
              f"dist losses {t['losses']} vs bench {bench_t[0]['losses']}")
        check(t["weight_bytes"] == bench_t[0]["weight_bytes"]
              and t["state_bytes"] == bench_t[0]["state_bytes"],
              "world size 1 holds other bytes than the bench step")
    for n in ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
              "fused_mlp_bwd_dx", "flash_bwd"):
        check(ws1_launches[n] > 0, f"world size 1: {n} never launched")
    # the 2-rank worlds' depth: world size 1's reference
    ws1, ws1_peak = ws1_losses(torch, tbench, tllama, 4, 2)
    gc_cuda(torch)
    return dict(turns=turns, ws1_launches=ws1_launches,
                ws1_big=dict(losses=ws1, peak_over_base=ws1_peak,
                             layers=BIG_LAYERS),
                seconds=time.perf_counter() - t0)


def dist_big_jobs(dist):
    """``beside``'s jobs for ``DIST_BIG``'s 2-rank worlds, in its
    order."""
    return tuple(gloo_world(dist, dist_big_rank, 2, (topo_kw, 2))
                 for _, topo_kw in DIST_BIG)


def dist_train_phase(torch, tbench, tllama, card, ws1, big):
    """The distributed train step at bench.py's width: ``ws1``, world
    size 1 (``dist_ws1_phase``); ``big``, the ranks of mp=2 and dp=2
    with ZeRO-1 by ``DIST_BIG``'s name (``dist_big_jobs``), each 2 ranks
    on the card over gloo (host-staged collectives: their times are no
    throughput) at ``BIG_LAYERS`` layers, 2 steps: per-rank peak memory,
    weight and optimizer-state bytes against the reckoning (weights /
    mp; AdamW states / 2), losses against world size 1 at that depth
    within ``DIST_LOSS_ATOL``, every train kernel launched."""
    t0 = time.perf_counter()
    ref = ws1["ws1_big"]
    rk = pp_reckoning(tllama, tbench, 1)
    W = rk["layers"] + rk["tail"]
    S1 = 2 * W                            # AdamW's two moments, bf16
    cfg = tllama.LlamaConfig(**big_model(tbench))
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    norms = (2 * L + 1) * H * 2            # ln1, ln2, norm_f in bf16
    reckon = {"mp2": dict(weight_bytes=(W - norms) // 2 + norms),
              "dp2_zero": dict(weight_bytes=W)}
    reckon["mp2"]["state_bytes"] = 2 * reckon["mp2"]["weight_bytes"]
    reckon["dp2_zero"]["state_bytes"] = S1 // 2
    out_big = {}
    for name, topo_kw in DIST_BIG:
        ranks = big[name]
        print(f"dist train [{card}]: {name} ranks {json.dumps(ranks)}")
        # the layer is whole at mp = 1: the fused blocks (whose attention
        # runs flash_fwd's kernel uncounted) and flash_bwd
        path = (("flash_fwd", "flash_bwd") if topo_kw.get("mp", 1) > 1
                else ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
                      "fused_mlp_bwd_dx", "flash_bwd"))
        for r in ranks:
            for k in ("weight_bytes", "state_bytes"):
                check(r[k] == reckon[name][k], f"{name}: {k} {r[k]} vs "
                      f"reckoned {reckon[name][k]}")
            # the full draw is freed: what stays is the shards (16 MiB of
            # slack: dp=2 kept 2,097,152 bytes more, not identified; a kept
            # draw at mp=2 is ~1e9)
            check(r["memory_allocated_after_init"]
                  <= r["weight_bytes"] + (16 << 20),
                  f"{name}: {r['memory_allocated_after_init']} bytes stay "
                  f"allocated after init, the shards are "
                  f"{r['weight_bytes']}")
            saved = (W - r["weight_bytes"]) + (S1 - r["state_bytes"])
            check(ref["peak_over_base"] - r["max_memory_allocated"]
                  >= 0.9 * saved, f"{name}: peak {r['max_memory_allocated']}"
                  f" vs world size 1's {ref['peak_over_base']}")
            err = max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
            check(err <= DIST_LOSS_ATOL, f"{name}: losses {r['losses']} vs "
                  f"world size 1 {ref['losses'][:2]}")
            for n in path:
                check(r["launches"][n] > 0, f"{name}: {n} never launched")
        out_big[name] = dict(
            ranks=[{k: r[k] for k in ("coords", "losses", "step_ms",
                                      "init_max_memory_allocated",
                                      "max_memory_allocated",
                                      "weight_bytes", "state_bytes",
                                      "launches")} for r in ranks],
            reckoned=reckon[name])
    turns = ws1["turns"]
    out = dict(turns=turns, ws1_launches=ws1["ws1_launches"], big=out_big,
               ws1_big=ref,
               seconds=ws1["seconds"] + time.perf_counter() - t0)
    print(f"dist train [{card}]: {json.dumps(out)}")
    print(f"dist train [{card}]: world size 1 step ms "
          f"{[round(t['step_ms'], 2) for t in turns]} in turns {DIST_TURNS}"
          f" (MFU {[round(t['mfu'], 2) for t in turns]} %), peaks over "
          f"what the process held {[t['peak_over_base'] for t in turns]}; "
          f"per-rank peaks "
          + ", ".join(f"{n} {[r['max_memory_allocated'] for r in b['ranks']]}"
                      for n, b in out_big.items()))
    return out


# the eager distributed API (dist_api_phase): one 2-rank gloo world on the
# card runs bench.py's Llama through fleet at dp=2 (gradient merge k=2, one
# micro-step of each update under recompute), the tensor-parallel layers
# at mp=2 and ERNIE-base at pp=2, in turn; the world-size-1 references run
# in this process beside it
API_UPDATES = 2             # gradient merge updates (2 micro-steps each)
API_ROWS = 2                # rows a rank a micro-step (the global batch 4)
API_MP = dict(vocab=32000, hidden=2048, inter=5504, B=4, S=2048)
API_MP_SMALL = dict(vocab=64, hidden=16, inter=32, B=2, S=8)
API_MP_SEED = 5
API_ERNIE = (8, 512, 20)    # B, S, masked positions a row; 2 steps
API_ERNIE_STEPS = 2
# f32 with TF32 off: the mp sums and the vocab-parallel softmax run in
# another order than the world-size-1 layers'.  The gradients' limit, max
# |diff| over max |world size 1| a tensor, lies between the sound runs'
# 1.6e-5 and the controls' readings on the H100: world size 1 with TF32
# on 2.5e-4 - 4.4e-3 (every weight and the biases before the head), in
# bf16 1.6e-3 - 6.6e-2
API_MP_LOSS_ATOL = 1e-4
API_MP_GRAD_REL = 1e-4
# update 1's merged bf16 gradient against world size 1's on the global
# batch, relative L2 (the largest over the tensors): 2.9e-3 sound on the
# H100, the controls 1.02 (rank 0's local gradient, unreduced) and 1.0
# (the sum in place of the average)
API_GRAD_REL = 5e-2
API_ERNIE_ATOL = 1e-4       # tests/test_torch_ernie.py's dist tolerance
API_FILES = "_dist_api_smoke"


def _bits_digest(torch, tensors):
    """An exact integer digest of the tensors' bits (equal bits, equal
    digests; a position-weighted sum, so permuted values differ)."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1)
        bits = bits.view({2: torch.int16, 4: torch.int32}[
            bits.element_size()]).long()
        w = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
        out.append(int((bits * w).sum().item()))
    return out


def _kernel_counts(tbench):
    return {n: w.launches for n, w in tbench.KERNELS.items()}


def _zero_counts(tbench):
    for w in tbench.KERNELS.values():
        w.launches = 0


def api_llama_rank(torch, paddle, dist, tbench, tllama, metrics, dev,
                   out_dir):
    """(a) bench.py's Llama (``BIG_LAYERS`` layers on the card) through
    ``fleet`` at dp=2 as a user's loop drives it: ``distributed_model``
    (``DataParallel`` over the dp group; under gradient merge its
    backward reduces nothing), ``distributed_optimizer`` (gradient merge
    k=2 over AdamW with ``ClipGradByGlobalNorm(1.0)``, averaging the
    merged gradient over dp at its second step), ``API_UPDATES`` updates
    of two micro-steps on the same rows, each a backward then
    ``opt.step()`` and ``opt.clear_grad()``, the second under
    ``fleet.utils.recompute``.  The gradient the inner optimizer
    receives is read (not changed) on its way in.  Rank 0 saves its
    first micro-step's local gradient, update 1's merged gradient and
    the parameters after update 1 for the world-size-1 check.  Then,
    outside the merge, a plain and a recompute backward on the same
    rows, whose gradients must be bit-equal."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.overlap import plan_buckets
    on_card = dev.type == "cuda"
    cfg = (tllama.LlamaConfig(remat_policy="dots", **big_model(tbench))
           if on_card else tllama.LlamaConfig(dtype=torch.float32,
                                              **DIST_SMALL))
    S = tbench.SEQ if on_card else 32
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.init(is_collective=True, strategy=strategy)
    rank = dist.get_rank()
    paddle.seed(0)
    net = tllama.LlamaForCausalLM(cfg)
    model = fleet.distributed_model(net)
    params = [p for p in net.parameters() if not p.stop_gradient]
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        learning_rate=DIST_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)))
    batch = tbench.make_batch(cfg, 2 * API_ROWS, S, dev)
    rows = slice(rank * API_ROWS, (rank + 1) * API_ROWS)
    ids = paddle.to_tensor(batch["input_ids"][rows])
    labels = paddle.to_tensor(batch["labels"][rows])
    grad_bytes = sum(p._t.numel() * p._t.element_size() for p in params)
    # the buckets of the merged update's reduction (average_gradients)
    n_buckets = len(plan_buckets([p._t for p in params], 25 << 20))
    inner = opt.inner_opt
    received = []
    inner_step = inner.step

    def observed_step():
        # the gradient the inner optimizer receives (update 1's only)
        if not received:
            received.append([p.grad._t.clone() for p in params])
        inner_step()
    inner.step = observed_step

    def reduced():
        c = collectives_by_op(metrics)
        lat = metrics.snapshot().get(
            'collective_latency_seconds{op="all_reduce"}', {})
        return (c["calls"].get("all_reduce", 0),
                c["bytes"].get("all_reduce", 0), 1e3 * lat.get("sum", 0.0))

    def micro(recompute, step=True, observe=None):
        _zero_counts(tbench)
        metrics.reset()
        _sync(torch, dev)
        t0 = time.perf_counter()
        if recompute:
            loss, _ = fleet.utils.recompute(model, ids, labels=labels)
        else:
            loss, _ = model(ids, labels=labels)
        fwd = _kernel_counts(tbench)
        loss.backward()
        _sync(torch, dev)
        t1 = time.perf_counter()
        out = dict(loss=loss.item(), ms=1e3 * (t1 - t0),
                   forward_launches=fwd, launches=_kernel_counts(tbench),
                   backward_all_reduce=reduced()[:2])
        if observe is not None:
            observe()
        if step:
            metrics.reset()
            _sync(torch, dev)
            t1 = time.perf_counter()
            opt.step()
            opt.clear_grad()
            _sync(torch, dev)
            out.update(step_ms=1e3 * (time.perf_counter() - t1),
                       step_all_reduce=reduced())
        return out

    def digest():
        return _bits_digest(torch, [p._t for p in params])

    def save_local():
        if rank == 0:
            torch.save({p.name: p.grad._t.detach().cpu() for p in params},
                       os.path.join(out_dir, "llama_local_grads.pt"))

    _reset_peak(torch, dev)
    updates = []
    for u in range(API_UPDATES):
        before, steps0 = digest(), inner._step_count
        a = micro(False, observe=save_local if u == 0 else None)
        unchanged = digest() == before and inner._step_count == steps0
        b = micro(True)
        stepped = inner._step_count == steps0 + 1
        both = []
        dist.all_gather_object(both, digest())
        if u == 0:
            merged = []
            dist.all_gather_object(merged, _bits_digest(torch, received[0]))
            if rank == 0:
                torch.save({p.name: g.cpu() for p, g in
                            zip(params, received[0])},
                           os.path.join(out_dir, "llama_merged_grads.pt"))
                torch.save({p.name: p._t.detach().cpu() for p in params},
                           os.path.join(out_dir, "llama_update1.pt"))
            received[0] = None
        updates.append(dict(plain=a, recompute=b,
                            unchanged_after_odd=unchanged,
                            inner_stepped_once=stepped,
                            params_bit_equal_across_ranks=both[0] == both[1]))
    peak = _peak(torch, dev)
    inner.step = inner_step
    # recompute against a plain backward on the same rows, outside the
    # merge (no optimizer step)
    for p in params:
        p.grad = None
    plain = micro(False, step=False)
    g_plain = [p.grad._t.clone() for p in params]
    for p in params:
        p.grad = None
    again = micro(True, step=False)
    same = all(torch.equal(p.grad._t, g) for p, g in zip(params, g_plain))
    del g_plain
    for p in params:
        p.grad = None
    return dict(updates=updates, recompute_pass=dict(
                    plain=plain, recompute=again, grads_bit_equal=same),
                merged_grads_bit_equal_across_ranks=merged[0] == merged[1],
                n_buckets=n_buckets, grad_bytes=grad_bytes, peak_bytes=peak,
                layers=cfg.num_hidden_layers, rows=API_ROWS, seq=S,
                n_params=sum(p._t.numel() for p in params))


def _mp_layers(paddle, fleet, shape):
    V, H, I = shape["vocab"], shape["hidden"], shape["inter"]
    return dict(emb=fleet.VocabParallelEmbedding(V, H),
                col=fleet.ColumnParallelLinear(H, I, gather_output=False),
                row=fleet.RowParallelLinear(I, H, input_is_parallel=True),
                head=fleet.ColumnParallelLinear(H, V, gather_output=False))


def _mp_loss(paddle, fleet, layers, ids, labels):
    h = layers["head"](layers["row"](layers["col"](layers["emb"](ids))))
    return paddle.mean(fleet.ParallelCrossEntropy()(h, labels))


def _mp_data(paddle, shape, dev):
    rng = np.random.default_rng(API_MP_SEED)
    V, B, S = shape["vocab"], shape["B"], shape["S"]
    return (paddle.to_tensor(rng.integers(0, V, (B, S)), place=dev),
            paddle.to_tensor(rng.integers(0, V, (B, S)), place=dev))


# the dim each mp layer's parameter splits over (None: whole on a rank)
MP_SPLIT = {"emb.weight": 0, "col.weight": 1, "col.bias": 0,
            "row.weight": 0, "row.bias": None, "head.weight": 1,
            "head.bias": 0}


def api_mp_rank(torch, paddle, dist, dev, out_dir):
    """(b) Llama-width tensor-parallel layers at mp=2 (``fleet.init`` with
    a second strategy in the same world): embedding, column, row and
    vocabulary projection, ``ParallelCrossEntropy`` over B 4 x 2048, one
    AdamW step; rank 0 saves the loss and the gathered gradients.
    Dropout masks inside and outside the RNG tracker."""
    from paddle_tpu_torch.distributed import fleet
    on_card = dev.type == "cuda"
    shape = API_MP if on_card else API_MP_SMALL
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    topo = fleet.init(is_collective=True, strategy=strategy)
    paddle.seed(API_MP_SEED)
    layers = _mp_layers(paddle, fleet, shape)
    params = [p for l in layers.values() for p in l.parameters()]
    opt = paddle.optimizer.AdamW(learning_rate=DIST_LR, parameters=params)
    ids, labels = _mp_data(paddle, shape, dev)
    _reset_peak(torch, dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    loss = _mp_loss(paddle, fleet, layers, ids, labels)
    loss.backward()
    _sync(torch, dev)
    t1 = time.perf_counter()
    opt.step()
    _sync(torch, dev)
    t2 = time.perf_counter()
    peak = _peak(torch, dev)
    grads = {}
    for name, dim in MP_SPLIT.items():
        lname, attr = name.split(".")
        g = getattr(layers[lname], attr).grad
        if dim is not None:
            parts = []
            dist.all_gather(parts, g, group="mp")
            g = paddle.concat(parts, axis=dim)
        grads[name] = g._t.detach().cpu()
    if topo.coords["mp"] == 0:
        torch.save({"loss": loss.item(), "grads": grads},
                   os.path.join(out_dir, "mp_grads.pt"))
    dist.model_parallel_random_seed(API_MP_SEED)
    ones = paddle.ones([1 << 16])
    with dist.get_rng_state_tracker().rng_state():
        inside = paddle.nn.functional.dropout(ones, 0.5)
    outside = paddle.nn.functional.dropout(ones, 0.5)
    masks = {}
    for what, m in (("inside", inside), ("outside", outside)):
        both = []
        dist.all_gather(both, m, group="mp")
        masks[what] = bool(torch.equal(both[0]._t, both[1]._t))
    return dict(loss=loss.item(), step_ms=1e3 * (t1 - t0),
                optimizer_ms=1e3 * (t2 - t1), peak_bytes=peak,
                weight_bytes=sum(p._t.numel() * p._t.element_size()
                                 for p in params),
                masks_equal=masks, shape=shape)


def api_ernie_rank(torch, dist, dev):
    """(c) ERNIE-base (f32, published width; small off the card) at pp=2:
    ``API_ERNIE_STEPS`` steps of ``build_pretrain_step``, with this
    rank's weight and state bytes."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ernie as ternie
    from paddle_tpu_torch.models import llama as tllama
    on_card = dev.type == "cuda"
    cfg = ternie.ErnieConfig() if on_card else ternie.ErnieConfig(
        **SMALL_ERNIE)
    B, S, n_masked = API_ERNIE if on_card else (4, 32, 5)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1}
    topo = fleet.init(is_collective=True, strategy=strategy)
    step, init = ternie.build_pretrain_step(cfg, topo, device=dev)
    params, opt = init(0)
    _reset_peak(torch, dev)
    losses, ms = [], []
    for i in range(API_ERNIE_STEPS):
        batch = ernie_batch(torch, cfg, B, S, n_masked, dev, seed=4 + i)
        t0 = time.perf_counter()
        _, _, m = step(params, opt, step.shard_batch(batch))
        losses.append(m["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(losses=losses, step_ms=ms, peak_bytes=_peak(torch, dev),
                coords=topo.coords,
                weight_bytes=sum(t.numel() * t.element_size() for t in
                                 tllama._paths(params).values()),
                state_bytes=opt.state_bytes(), shape=dict(
                    B=B, S=S, masked=n_masked, layers=cfg.num_hidden_layers))


def dist_api_rank(out_dir, device="cuda"):
    """What each rank of ``dist_api_phase``'s 2-rank world runs: (a), (b)
    and (c) in turn, each with its own strategy."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.profiler import metrics
    dev = _device(torch, device)
    paddle.set_device(dev)
    flags.set_flags({"FLAGS_tpu_metrics": True})
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank()}
    out["llama"] = api_llama_rank(torch, paddle, dist, tbench, tllama,
                                  metrics, dev, out_dir)
    if dev.type == "cuda":
        gc_cuda(torch)
    t1 = time.perf_counter()
    out["mp"] = api_mp_rank(torch, paddle, dist, dev, out_dir)
    if dev.type == "cuda":
        gc_cuda(torch)
    t2 = time.perf_counter()
    out["ernie"] = api_ernie_rank(torch, dist, dev)
    out["seconds"] = dict(llama=t1 - t0, mp=t2 - t1,
                          ernie=time.perf_counter() - t2)
    return out


def dist_api_job(dist, out_dir, device="cuda"):
    """``beside``'s job for ``dist_api_phase``'s world."""
    return gloo_world(dist, dist_api_rank, 2, (out_dir, device), device)


def dist_api_refs(torch, tbench, tllama, out_dir, device="cuda"):
    """The world-size-1 references of ``dist_api_phase``, run here while
    its world runs: the eager Llama's gradient and first AdamW step on
    the global batch (a); the mp layers at world size 1 from the same
    seed, in float32 with TF32 off and, as the controls that the gate
    must tell from it, with TF32 on and in bfloat16 (b); ERNIE's steps
    at world size 1 (c)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import HybridTopology, fleet
    from paddle_tpu_torch.models import ernie as ternie
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    paddle.set_device(dev)
    t0 = time.perf_counter()
    cfg = (tllama.LlamaConfig(remat_policy="dots", **big_model(tbench))
           if on_card else tllama.LlamaConfig(dtype=torch.float32,
                                              **DIST_SMALL))
    S = tbench.SEQ if on_card else 32
    paddle.seed(0)
    net = tllama.LlamaForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(
        learning_rate=DIST_LR, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    batch = tbench.make_batch(cfg, 2 * API_ROWS, S, dev)
    loss, _ = net(paddle.to_tensor(batch["input_ids"]),
                  labels=paddle.to_tensor(batch["labels"]))
    loss.backward()
    grads = {p.name: p.grad._t.clone() for p in net.parameters()
             if not p.stop_gradient}
    opt.step()
    llama = dict(loss=loss.item(), grads=grads, params={
        p.name: p._t.detach() for p in net.parameters()
        if not p.stop_gradient})
    del net, opt, loss, grads
    shape = API_MP if on_card else API_MP_SMALL
    ids, labels = _mp_data(paddle, shape, dev)

    def mp_layers(dtype):
        paddle.seed(API_MP_SEED)
        layers = _mp_layers(paddle, fleet, shape)
        if dtype is not None:
            for l in layers.values():
                l.to(dtype=dtype)
        mloss = _mp_loss(paddle, fleet, layers, ids, labels)
        mloss.backward()
        return layers, mloss.item(), {
            n: getattr(layers[n.split(".")[0]], n.split(".")[1]).grad._t
            .float() for n in MP_SPLIT}

    layers, mloss, mgrads = mp_layers(None)
    mp = dict(loss=mloss, grads=mgrads, weight_bytes=sum(
        p._t.numel() * p._t.element_size()
        for l in layers.values() for p in l.parameters()),
        row_bias_bytes=layers["row"].bias._t.numel() * 4)
    del layers
    controls = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        controls["tf32"] = mp_layers(None)[2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    controls["bf16"] = mp_layers("bfloat16")[2]
    mp["control_rel_err"] = {k: _max_rel(torch, g, mgrads)
                             for k, g in controls.items()}
    del controls
    ecfg = ternie.ErnieConfig() if on_card else ternie.ErnieConfig(
        **SMALL_ERNIE)
    B, S, n_masked = API_ERNIE if on_card else (4, 32, 5)
    step, init = ternie.build_pretrain_step(ecfg, HybridTopology(),
                                            device=dev)
    params, eopt = init(0)
    losses = [step(params, eopt, ernie_batch(torch, ecfg, B, S, n_masked,
                                             dev, seed=4 + i))[2]["loss"]
              .item() for i in range(API_ERNIE_STEPS)]
    flat = tllama._paths(params)
    ernie = dict(losses=losses, layer_bytes=sum(
        t.numel() * t.element_size() for k, t in flat.items()
        if k.startswith("layers")), rest_bytes=sum(
        t.numel() * t.element_size() for k, t in flat.items()
        if not k.startswith("layers")))
    del params, eopt
    return dict(llama=llama, mp=mp, ernie=ernie,
                seconds=time.perf_counter() - t0)


def _max_rel(torch, got, ref):
    """Each tensor's max |got - ref| over its max |ref|, by name."""
    return {n: float((got[n].to(r.device).float() - r.float()).abs().max()
                     / r.float().abs().max().clamp_min(1e-30))
            for n, r in ref.items()}


def _rel_l2(torch, got, ref, scale=1.0):
    """The largest over the tensors of ||scale got - ref|| / ||ref||."""
    worst = 0.0
    for n, r in ref.items():
        r = r.float()
        d = got[n].to(r.device).float() * scale - r
        worst = max(worst, float(d.norm() / r.norm().clamp_min(1e-30)))
    return worst


def dist_api_phase(torch, tbench, card, ranks, refs, eager, out_dir,
                   seconds, device="cuda"):
    """The eager distributed API on the card (``dist_api_rank``'s world
    beside ``dist_api_refs``): the gates of (a), (b) and (c), then the
    phase's numbers."""
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    ranks = sorted(ranks, key=lambda r: r["rank"])
    res = {"seconds": seconds, "refs_seconds": refs["seconds"],
           "rank_seconds": [r["seconds"] for r in ranks]}
    # (a) fleet at dp=2
    la = [r["llama"] for r in ranks]
    L = la[0]["layers"]
    eager_per = eager["llama"]["launches_per_step"] if eager else None
    L_eager = tbench.MODEL["num_hidden_layers"]

    def launches_ok(what, a, b):
        """``a`` a plain micro-step's, ``b`` a recompute one's."""
        check(b["forward_launches"] == a["forward_launches"],
              f"dist api: {what}: recompute forward "
              f"{b['forward_launches']} vs {a['forward_launches']}")
        check(all(b["launches"][n] == a["launches"][n]
                  + a["forward_launches"][n] for n in a["launches"]),
              f"dist api: {what}: recompute launches {b['launches']} vs "
              f"plain {a['launches']} + forward {a['forward_launches']}")
        if on_card:
            want = {n: c * L / L_eager for n, c in eager_per.items()}
            check(a["launches"] == want, f"dist api: {what}: a micro-step's "
                  f"launches {a['launches']} vs the eager step's at {L} "
                  f"layers {want}")
            for n in ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
                      "fused_mlp_bwd_dx", "flash_bwd"):
                check(a["launches"][n] > 0, f"dist api: {n} never launched")

    merged_ar = (la[0]["n_buckets"], la[0]["grad_bytes"])
    for r in la:
        check(r["merged_grads_bit_equal_across_ranks"],
              "dist api: the ranks' merged gradients differ")
        for u, up in enumerate(r["updates"]):
            check(up["unchanged_after_odd"], f"dist api: update {u}: the "
                  f"parameters moved after an odd micro-step")
            check(up["inner_stepped_once"], f"dist api: update {u}: the "
                  f"inner optimizer did not step once")
            check(up["params_bit_equal_across_ranks"], f"dist api: update "
                  f"{u}: the ranks' parameters differ")
            a, b = up["plain"], up["recompute"]
            # no backward reduces; the merged update reduces each bucket
            # once, in the second micro-step's opt.step()
            check(a["backward_all_reduce"] == b["backward_all_reduce"]
                  == a["step_all_reduce"][:2] == (0, 0),
                  f"dist api: update {u}: a backward or the odd step "
                  f"reduced: {a['backward_all_reduce']}, "
                  f"{b['backward_all_reduce']}, {a['step_all_reduce']}")
            check(b["step_all_reduce"][:2] == merged_ar,
                  f"dist api: update {u}: the merged update's all_reduce "
                  f"{b['step_all_reduce'][:2]} vs the buckets' {merged_ar}")
            launches_ok(f"update {u}", a, b)
        rp = r["recompute_pass"]
        check(rp["grads_bit_equal"], "dist api: the recompute backward's "
              "grads differ from the plain one's")
        launches_ok("recompute pass", rp["plain"], rp["recompute"])
    # update 1's merged gradient against world size 1's on the global
    # batch; the controls: rank 0's local gradient (no reduction) and
    # the sum in place of the average
    ref_g = refs["llama"]["grads"]
    merged = torch.load(os.path.join(out_dir, "llama_merged_grads.pt"))
    grad_err = _rel_l2(torch, merged, ref_g)
    grad_sum = _rel_l2(torch, merged, ref_g, scale=2.0)
    del merged
    local = torch.load(os.path.join(out_dir, "llama_local_grads.pt"))
    grad_local = _rel_l2(torch, local, ref_g)
    del local
    check(grad_err <= API_GRAD_REL, f"dist api: update 1's merged gradient "
          f"off world size 1's by {grad_err} (relative L2; limit "
          f"{API_GRAD_REL}; controls: local {grad_local}, sum {grad_sum})")
    got = {k: v.float().numpy() for k, v in torch.load(
        os.path.join(out_dir, "llama_update1.pt")).items()}
    ref_p = {k: v.float().cpu().numpy()
             for k, v in refs["llama"]["params"].items()}
    excess = dist_param_check(got, ref_p, 1,
                              "dist api: update 1 against world size 1")
    del got, ref_p
    loss0 = float(np.mean([r["updates"][0]["plain"]["loss"] for r in la]))
    loss_err = abs(loss0 - refs["llama"]["loss"])
    check(loss_err <= DIST_LOSS_ATOL, f"dist api: micro-step 1's loss "
          f"{loss0} vs world size 1 {refs['llama']['loss']}")
    res["llama"] = dict(
        micro_ms={k: [[r["updates"][u][k]["ms"] for u in range(
            API_UPDATES)] for r in la] for k in ("plain", "recompute")},
        odd_step_ms=[[up["plain"]["step_ms"] for up in r["updates"]]
                     for r in la],
        merged_step_ms=[[up["recompute"]["step_ms"] for up in r["updates"]]
                        for r in la],
        merged_all_reduce_ms=[[up["recompute"]["step_all_reduce"][2]
                               for up in r["updates"]] for r in la],
        reduction_share=[[up["recompute"]["step_all_reduce"][2] / (
            up["plain"]["ms"] + up["plain"]["step_ms"] + up["recompute"]["ms"]
            + up["recompute"]["step_ms"]) for up in r["updates"]]
            for r in la],
        all_reduce_per_merged_update=dict(calls=merged_ar[0],
                                          bytes=merged_ar[1]),
        peak_bytes=[r["peak_bytes"] for r in la],
        launches_plain=la[0]["updates"][0]["plain"]["launches"],
        launches_recompute=la[0]["updates"][0]["recompute"]["launches"],
        losses=[[(up["plain"]["loss"], up["recompute"]["loss"])
                 for up in r["updates"]] for r in la],
        ws1_loss=refs["llama"]["loss"], loss_err=loss_err,
        merged_grad_rel_l2=grad_err, grad_limit=API_GRAD_REL,
        control_local_rel_l2=grad_local, control_sum_rel_l2=grad_sum,
        param_excess_bf16_steps=excess, layers=L, rows=la[0]["rows"],
        seq=la[0]["seq"], n_params=la[0]["n_params"],
        eager_step_ms=eager["llama"]["step_ms"] if eager else None)
    # (b) mp=2
    mp = [r["mp"] for r in ranks]
    ref = refs["mp"]
    half = (ref["weight_bytes"] - ref["row_bias_bytes"]) // 2 \
        + ref["row_bias_bytes"]
    for r in mp:
        check(r["weight_bytes"] == half, f"dist api: mp rank weights "
              f"{r['weight_bytes']} vs half of world size 1's {half}")
        check(abs(r["loss"] - ref["loss"]) <= API_MP_LOSS_ATOL,
              f"dist api: mp loss {r['loss']} vs {ref['loss']}")
        check(not r["masks_equal"]["inside"] and r["masks_equal"]["outside"],
              f"dist api: dropout masks {r['masks_equal']}")
    got = torch.load(os.path.join(out_dir, "mp_grads.pt"))
    rel = {}
    for n, g in got["grads"].items():
        want = ref["grads"][n]
        rel[n] = float((g.to(want.device) - want).abs().max()
                       / want.abs().max().clamp_min(1e-30))
        check(rel[n] <= API_MP_GRAD_REL, f"dist api: mp grad {n} off by "
              f"{rel[n]} of its max (controls: "
              f"{ref['control_rel_err']})")
    res["mp"] = dict(loss=mp[0]["loss"], ws1_loss=ref["loss"],
                     grad_rel_err=rel, grad_limit=API_MP_GRAD_REL,
                     control_rel_err=ref["control_rel_err"], step_ms=[r["step_ms"] for r in mp],
                     optimizer_ms=[r["optimizer_ms"] for r in mp],
                     peak_bytes=[r["peak_bytes"] for r in mp],
                     weight_bytes=mp[0]["weight_bytes"],
                     ws1_weight_bytes=ref["weight_bytes"])
    # (c) ERNIE at pp=2
    er = [r["ernie"] for r in ranks]
    eref = refs["ernie"]
    want_w = eref["rest_bytes"] + eref["layer_bytes"] // 2
    for r in er:
        check(r["weight_bytes"] == want_w and r["state_bytes"] == 2 * want_w,
              f"dist api: ernie pp rank bytes {r['weight_bytes']} / "
              f"{r['state_bytes']} vs {want_w} / {2 * want_w}")
        err = max(abs(a - b) for a, b in zip(r["losses"], eref["losses"]))
        check(err <= API_ERNIE_ATOL, f"dist api: ernie pp losses "
              f"{r['losses']} vs world size 1 {eref['losses']}")
    res["ernie"] = dict(losses=er[0]["losses"], ws1_losses=eref["losses"],
                        step_ms=[r["step_ms"] for r in er],
                        peak_bytes=[r["peak_bytes"] for r in er],
                        weight_bytes=er[0]["weight_bytes"],
                        state_bytes=er[0]["state_bytes"],
                        shape=er[0]["shape"])
    print(f"dist api [{card}]: {json.dumps(res)}")
    return res


# the pipeline and context-parallel checks of a small bf16 model (the
# composition: flash_fwd and flash_bwd on every path): a 4-rank world
# runs dp=2 x pp=2 under each schedule (2 layers: interleaved takes v=1,
# one layer a rank) and pp=2 x sp=2 on GPipe; a 2-rank world sp=2
PP_SMALL_CASES = (
    ("dp2xpp2_gpipe", dict(dp=2, pp=2), dict(schedule="gpipe")),
    ("dp2xpp2_1f1b", dict(dp=2, pp=2), dict(schedule="1f1b")),
    ("dp2xpp2_1f1b_overlap", dict(dp=2, pp=2),
     dict(schedule="1f1b", overlap=True)),
    ("dp2xpp2_interleaved", dict(dp=2, pp=2),
     dict(schedule="interleaved", virtual_pp=1)),
    ("pp2xsp2_gpipe", dict(pp=2, sp=2), dict(schedule="gpipe")))
CP_SMALL_CASES = (("sp2", dict(sp=2), {}),)
TAIL = ("embed", "norm_f", "lm_head")


def small_pp_check(torch, dist, worlds):
    """The pipeline schedules and context parallelism of the small bf16
    model as gloo ranks on the one card (``PP_SMALL_CASES``,
    ``CP_SMALL_CASES``), 2 steps each from the same seed, held to its
    world-size-1 step on the card: losses within ``DIST_LOSS_ATOL``,
    params by ``dist_param_check``; the ranks that hold one block of the
    params (over dp and sp) the same bits, the embedding, norm and head
    the same bits on every stage; 1F1B overlapped the same bits as
    lockstep.  ``worlds``: ``small_worlds``'s ranks."""
    ref = worlds["ref"]
    steps = DIST_SMALL_SHAPE[2]
    rows = {}
    by_name = {}
    for ranks, cases in ((worlds["pp"], PP_SMALL_CASES),
                         (worlds["cp"], CP_SMALL_CASES)):
        for i, (name, _, _) in enumerate(cases):
            res = by_name[name] = [r[i] for r in ranks]
            err = max(abs(a - b) for r in res
                      for a, b in zip(r["losses"], ref["losses"]))
            check(err <= DIST_LOSS_ATOL, f"small pp {name}: losses "
                  f"{res[0]['losses']} vs world size 1 {ref['losses']}")
            ulps = max(dist_param_check(r["params"], ref["params"], steps,
                                        f"small pp {name}") for r in res)
            blocks = {}
            for r in res:
                blocks.setdefault((r["coords"]["pp"], r["coords"]["mp"]),
                                  []).append(r["local"])
            for group in blocks.values():
                for other in group[1:]:
                    check(all(np.array_equal(other[k], v)
                              for k, v in group[0].items()),
                          f"small pp {name}: replicas differ")
            for r in res[1:]:
                check(all(np.array_equal(r["local"][k], res[0]["local"][k])
                          for k in TAIL), f"small pp {name}: the tail "
                      "differs between stages")
            rows[name] = dict(losses=res[0]["losses"], loss_err=err,
                              param_excess_bf16_steps=ulps)
    lock, over = by_name["dp2xpp2_1f1b"], by_name["dp2xpp2_1f1b_overlap"]
    for a, b in zip(lock, over):
        check(a["losses"] == b["losses"]
              and all(np.array_equal(a["local"][k], v)
                      for k, v in b["local"].items()),
              "small pp: 1F1B overlapped differs from lockstep")
    print(f"small pp check (gloo ranks on one card, bf16): world size 1 "
          f"losses {ref['losses']}; "
          + json.dumps(rows))
    return rows


# bench.py's shape through the pipeline: 2 ranks at pp=2, a global batch
# of 8 rows in 8 microbatches, each schedule 2 steps
PP_BIG_CASES = (("gpipe", dict(schedule="gpipe")),
                ("1f1b", dict(schedule="1f1b")),
                ("1f1b_overlap", dict(schedule="1f1b", overlap=True)),
                ("interleaved", dict(schedule="interleaved", virtual_pp=2)))
PP_BIG_BATCH, PP_BIG_MICRO, BIG_STEPS = 8, 8, 2


def big_rank(topo_kw, cases, B, steps):
    """What each rank of ``pipeline_phase`` and ``cp_phase`` runs: the
    distributed step at bench.py's shape for each case ``(name, build
    kwargs)``, from seed 0, on this rank's rows of one batch: losses,
    step ms (host clock), the step peak over what the rank held before
    the steps, the bytes of its weights and optimizer state, its
    kernel launches (counts set to 0 just before the steps) and its
    ``ppermute`` calls and bytes a step."""
    import gc
    import torch
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.profiler import metrics
    flags.set_flags({"FLAGS_tpu_metrics": True})
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig(remat_policy="dots", **big_model(tbench))
    topo = init_mesh(**topo_kw)
    batch = topo.shard_batch(tbench.make_batch(cfg, B, tbench.SEQ, dev))
    out = {}
    for name, kw in cases:
        step, init = tllama.build_train_step(cfg, topo, device=dev, **kw)
        params, opt = init(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for w in tbench.KERNELS.values():
            w.launches = 0
        losses, ms, p2p = [], [], []
        for _ in range(steps):
            metrics.reset()
            t0 = time.perf_counter()
            losses.append(step(params, opt, batch)[2]["loss"].item())
            ms.append(1e3 * (time.perf_counter() - t0))
            snap = metrics.snapshot()
            p2p.append([snap.get(f'collective_{k}_total{{op="ppermute"}}',
                                 0.0) for k in ("calls", "bytes")])
        out[name] = dict(
            losses=losses, step_ms=ms,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            peak_over_base=torch.cuda.max_memory_allocated(dev) - base,
            weight_bytes=sum(t.numel() * t.element_size()
                             for t in tbench.leaves(params)),
            state_bytes=opt.state_bytes(),
            launches={n: w.launches for n, w in tbench.KERNELS.items()},
            ppermute_calls_bytes=p2p)
        del params, opt, step, init
        gc.collect()
        torch.cuda.empty_cache()
    return dict(coords=topo.coords, runs=out)


def ws1_losses(torch, tbench, tllama, B, steps):
    """``bench.train_step`` at bench.py's width and the 2-rank worlds'
    depth (``BIG_LAYERS``) on ``B`` rows (the same batch as the
    ranks'), ``steps`` steps: the losses and the peak over what the
    process held."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig(remat_policy="dots", **big_model(tbench))
    gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = tllama.init_params(cfg, 0, device=dev)
    for t in tbench.leaves(params):
        t.requires_grad_(True)
    opt = tbench.make_optimizer(params)
    batch = tbench.make_batch(cfg, B, tbench.SEQ, dev)
    losses = [float(tbench.train_step(cfg, params, opt, batch))
              for _ in range(steps)]
    peak = torch.cuda.max_memory_allocated(dev) - base
    del params, opt
    gc_cuda(torch)
    return losses, peak


def pp_reckoning(tllama, tbench, pp):
    """Bytes of a pp rank's weights at ``BIG_LAYERS`` layers: its L/pp
    layers and the embedding, head and final norm whole."""
    cfg = tllama.LlamaConfig(**big_model(tbench))
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    KV = cfg.num_key_value_heads * cfg.head_dim
    layer = (2 * H * H + 2 * H * KV + 3 * H * I + 2 * H) * 2
    return dict(layers=layer * L // pp, tail=(2 * V * H + H) * 2)


def schedule_launches(L_local, n_micro, schedule):
    """Launches a step of the fused path's train kernels on one stage:
    each unit of a rank runs its layers forward once; GPipe's and the
    interleaved schedule's backward recomputes each layer once under
    "dots" (the fused forward kernels are not kept), 1F1B's backward
    unit recomputes the stage from its kept input and then each layer
    again; the backward kernels run once a layer and microbatch."""
    fwd = {"gpipe": 2, "interleaved": 2, "1f1b": 3}[schedule]
    per = L_local * n_micro
    return {"flash_fwd": 0, "flash_bwd": per, "fused_qkv": fwd * per,
            "fused_attn_epilogue": fwd * per, "fused_mlp_fwd": fwd * per,
            "fused_mlp_bwd_dx": per}


def pipeline_phase(torch, tbench, tllama, dist, card):
    """bench.py's width at ``BIG_LAYERS`` layers (S = 2048, bf16, "dots",
    the fused blocks by the default policy) through the pipeline as 2
    ranks at pp=2 over
    gloo (host-staged: step times are no throughput), global batch 8 in
    8 microbatches: GPipe, 1F1B lockstep and overlapped, interleaved
    with v=2, 2 steps each in one world.  Per rank: weight and AdamW
    state bytes equal their reckoning; 1F1B's step peak below GPipe's;
    the launches of rows 1-10 equal the schedule's count; the losses
    within ``DIST_LOSS_ATOL`` of world size 1's on the same 8 rows; 1F1B
    overlapped the same loss bits as lockstep; the ranks' ``ppermute``
    bytes a step equal two transfers of a microbatch's activation a hop
    between consecutive global stages."""
    t0 = time.perf_counter()
    ws1, ws1_peak = ws1_losses(torch, tbench, tllama, PP_BIG_BATCH,
                               BIG_STEPS)
    cases = tuple((n, dict(kw, n_microbatches=PP_BIG_MICRO))
                  for n, kw in PP_BIG_CASES)
    ranks = dist.launch.spawn(big_rank, 2, (dict(pp=2), cases, PP_BIG_BATCH,
                                     BIG_STEPS), device="cuda",
                       backend="gloo", timeout=900)
    rk = pp_reckoning(tllama, tbench, 2)
    weights = rk["layers"] + rk["tail"]
    L_local = BIG_LAYERS // 2
    for r in ranks:
        runs = r["runs"]
        for name, kw in PP_BIG_CASES:
            x = runs[name]
            check(x["weight_bytes"] == weights
                  and x["state_bytes"] == 2 * weights,
                  f"pipeline {name}: weights {x['weight_bytes']} / states "
                  f"{x['state_bytes']} vs reckoned {weights} / "
                  f"{2 * weights}")
            want = schedule_launches(L_local, PP_BIG_MICRO, kw["schedule"])
            check(x["launches"] == {n: BIG_STEPS * c
                                    for n, c in want.items()},
                  f"pipeline {name}: launches {x['launches']} vs "
                  f"{BIG_STEPS} x {want}")
            err = max(abs(a - b) for a, b in zip(x["losses"], ws1))
            check(err <= DIST_LOSS_ATOL, f"pipeline {name}: losses "
                  f"{x['losses']} vs world size 1 {ws1}")
        check(runs["1f1b"]["max_memory_allocated"]
              < runs["gpipe"]["max_memory_allocated"],
              f"pipeline: 1F1B peak {runs['1f1b']['max_memory_allocated']}"
              f" not below GPipe's {runs['gpipe']['max_memory_allocated']}")
        check(runs["1f1b"]["losses"] == runs["1f1b_overlap"]["losses"],
              "pipeline: 1F1B overlapped losses differ from lockstep")
    # every hop between consecutive global stages carries a microbatch's
    # activation forward and its gradient back, once a step
    cfg = tllama.LlamaConfig(**tbench.MODEL)
    edge = (PP_BIG_BATCH // PP_BIG_MICRO) * tbench.SEQ * cfg.hidden_size * 2
    for name, kw in PP_BIG_CASES:
        hops = 2 * kw.get("virtual_pp", 1) - 1
        for i in range(BIG_STEPS):
            sent = sum(r["runs"][name]["ppermute_calls_bytes"][i][1]
                       for r in ranks)
            check(sent == 2 * hops * PP_BIG_MICRO * edge,
                  f"pipeline {name}: {sent} bytes sent a step vs 2 x "
                  f"{hops} hops x {PP_BIG_MICRO} x {edge}")
    out = dict(ws1_losses=ws1, ws1_peak_over_base=ws1_peak,
               reckoned_weight_bytes=weights, ranks=ranks,
               seconds=time.perf_counter() - t0)
    print(f"pipeline [{card}]: {json.dumps(out)}")
    print(f"pipeline [{card}]: per-rank step peaks "
          + ", ".join(f"{n} {[r['runs'][n]['max_memory_allocated'] for r in ranks]}"
                      for n, _ in PP_BIG_CASES)
          + f"; world size 1 (B = 8) peak over base {ws1_peak}")
    return out


CP_BIG_BATCH = 4


def cp_job(dist):
    """``beside``'s job for ``cp_phase``'s 2-rank world."""
    return gloo_world(dist, big_rank, 2, (dict(sp=2), (("sp2", {}),),
                                          CP_BIG_BATCH, BIG_STEPS),
                      timeout=900)


def cp_phase(torch, tbench, tllama, card, ws1, ws1_peak, ranks):
    """bench.py's width at ``BIG_LAYERS`` layers context parallel: 2
    ranks at sp=2 over gloo, B = 4, 2 steps; ``ws1``/``ws1_peak``: world
    size 1's losses and peak on the same batch and depth
    (``ws1_losses(torch, tbench, tllama, 4, 2)``).  Losses within
    ``DIST_LOSS_ATOL``; the fused MLP kernels launched on the rank's
    S/2 rows and the fused attention block not (attention is the
    ring); ``ppermute`` calls and bytes a step equal the code's count:
    2 (k, v) x (sp - 1) x L blocks a forward, again in the remat
    recompute and again, reversed, in the backward.  ``ranks``: the
    world's (``cp_job``)."""
    t0 = time.perf_counter()
    cfg = tllama.LlamaConfig(**big_model(tbench))
    sp, L = 2, cfg.num_hidden_layers
    block = (CP_BIG_BATCH * tbench.SEQ // sp * cfg.num_key_value_heads
             * cfg.head_dim * 2)
    calls = 3 * 2 * (sp - 1) * L
    for r in ranks:
        x = r["runs"]["sp2"]
        err = max(abs(a - b) for a, b in zip(x["losses"], ws1))
        check(err <= DIST_LOSS_ATOL, f"cp: losses {x['losses']} vs world "
              f"size 1 {ws1}")
        la = x["launches"]
        check(la["fused_mlp_fwd"] > 0 and la["fused_mlp_bwd_dx"] > 0
              and la["fused_qkv"] == la["fused_attn_epilogue"] == 0
              and la["flash_fwd"] == la["flash_bwd"] == 0,
              f"cp: launches {la}")
        check(la["fused_mlp_fwd"] == BIG_STEPS * 2 * L
              and la["fused_mlp_bwd_dx"] == BIG_STEPS * L,
              f"cp: fused MLP launches {la}")
        for c, b in x["ppermute_calls_bytes"]:
            check(c == calls and b == calls * block, f"cp: ppermute {c} "
                  f"calls / {b} bytes a step vs {calls} / {calls * block}")
    out = dict(ranks=ranks, ws1_losses=ws1, ws1_peak_over_base=ws1_peak,
               ppermute_block_bytes=block, ppermute_calls=calls,
               seconds=time.perf_counter() - t0)
    print(f"cp [{card}]: {json.dumps(out)}")
    return out


def multichip_line(card):
    """``python -m paddle_tpu_torch.bench --multichip``'s measuring
    function once on the card (8 gloo ranks, trace on): the recorded
    schedule matches the static one and overlap serializes fewer
    transfers than lockstep."""
    from paddle_tpu_torch import bench as tbench
    t0 = time.perf_counter()
    res = tbench.multichip(trace_out="chiprun_out/multichip_trace")
    ov = res["detail"]["overlap"]
    check(ov["measured"]["matches_static"], f"multichip: {ov}")
    check(ov["serialized_transfers"] < ov["serialized_transfers_lockstep"],
          f"multichip: {ov}")
    check(res["detail"]["loss"] == res["detail"]["loss_lockstep"],
          "multichip: overlapped and lockstep losses differ")
    print(f"multichip [{card}] ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(res))
    return res


# the MoE phases' model: bench.py's ~0.95B shape as the reference's
# llama1b preset with 8 experts (top 2, capacity factor 1.25, the
# reference's defaults), S = 2048, B = 4, bf16, "dots"
MOE_EXPERTS, MOE_B, MOE_STEPS = 8, 4, 5
MOE_DIST_STEPS = 2


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(torch, dev):
    """Peak device memory since ``_reset_peak`` (0 off the card, where
    the phases are rehearsed at a tiny size)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _device(torch, device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def moe_cfg(tllama, **kw):
    return tllama.preset("llama1b", moe_num_experts=MOE_EXPERTS,
                         remat_policy="dots", **kw)


def moe_reckoning(cfg, dp=1):
    """(parameters, expert parameters, weight bytes a rank at dp (the
    experts split over it; the router f32), AdamW state bytes a rank
    (ZeRO over dp halves every other leaf's two moments; every leaf here
    has a dim that splits))."""
    H, I, L, E, V = (cfg.hidden_size, cfg.intermediate_size,
                     cfg.num_hidden_layers, cfg.moe_num_experts,
                     cfg.vocab_size)
    dense = 2 * V * H + L * (4 * H * H + 2 * H) + H
    router = L * H * E
    experts = L * E * 3 * H * I
    item = cfg.dtype.itemsize
    weights = item * dense + 4 * router + item * experts // dp
    states = 2 * (item * dense + 4 * router) // dp \
        + 2 * (item * experts // dp)
    return dense + router + experts, experts, weights, states


def moe_collective_reckoning(cfg, rows, seq, dp, opt):
    """Calls and bytes by op of one train step of a rank at dp (= the
    batch ranks; no mp, sp or pp), from the code: per MoE layer and
    forward pass (2 under remat: the forward and its recompute) an
    all-gather of the per-row expert counts ([rows, E] int64), the
    dispatch's reduce-scatter of the [E, C, H] buffer, the combine's
    all-gather of this rank's [E/dp, C, H] outputs and the aux's
    all-reduce of [2E] f32; the backward a reduce-scatter of the
    combine's gradient, an all-gather of the dispatch's and an
    all-reduce of the aux's.  Then ``opt``'s ZeRO reductions (a
    reduce-scatter and an all-gather a sharded leaf, an all-reduce an
    unsharded one over a group of more than one rank: none for an
    expert leaf at dp alone) and the loss's all-reduce of 2 f32."""
    from paddle_tpu_torch.distributed import ONE_RANK
    E, K, H, L = (cfg.moe_num_experts, cfg.moe_top_k, cfg.hidden_size,
                  cfg.num_hidden_layers)
    C = max(1, int(cfg.moe_capacity_factor * rows * seq * dp * K / E))
    buf = E * C * H * cfg.dtype.itemsize
    mine = buf // dp
    fwd = 2 if cfg.use_remat else 1
    calls = {"all_gather": L * (2 * fwd + 1),
             "reduce_scatter": L * (fwd + 1),
             "all_reduce": L * (fwd + 1) + 1}
    nbytes = {"all_gather": L * (fwd * (rows * E * 8 + mine) + mine),
              "reduce_scatter": L * (fwd + 1) * buf,
              "all_reduce": L * (fwd + 1) * 2 * E * 4 + 8}
    for path, p, d, t in opt.leaves:
        batch_group, rest_group = opt.sum_groups[path]
        nb = p.numel() * p.element_size()
        if d is None:
            if batch_group is not ONE_RANK:
                calls["all_reduce"] += 1
                nbytes["all_reduce"] += nb
            continue
        tb = t.numel() * t.element_size()
        calls["reduce_scatter"] += 1
        nbytes["reduce_scatter"] += nb
        calls["all_gather"] += 1
        nbytes["all_gather"] += tb
        if rest_group is not ONE_RANK:
            calls["all_reduce"] += 1
            nbytes["all_reduce"] += tb
    return {"calls": calls, "bytes": nbytes}


def collectives_by_op(metrics):
    """{"calls": {op: n}, "bytes": {op: n}} since ``metrics.reset()``."""
    out = {"calls": {}, "bytes": {}}
    for k, v in metrics.snapshot().items():
        for name, key in (("collective_calls_total", "calls"),
                          ("collective_bytes_total", "bytes")):
            if k.startswith(name + "{"):
                out[key][k.split('op="')[1].split('"')[0]] = int(v)
    return out


def moe_train_phase(torch, tbench, tllama, dist, card, device="cuda"):
    """The MoE model's train step at world size 1 through
    ``Plan().train_step`` (no process group): 1 warmup + ``MOE_STEPS``
    timed steps on bench.py's batch.  Step ms, tokens/s, peak memory
    over what the process held, the dropped share of the (t, k)
    assignments (``llama.moe_routing``), the launches a step of rows 1-8
    (rows 9-10 must stay 0: the MoE layer takes the MLP's place) and the
    weight bytes against their reckoning."""
    cfg = moe_cfg(tllama)
    n, n_exp, W, _ = moe_reckoning(cfg)
    dev = _device(torch, device)
    if dev.type == "cuda":
        gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    step, init = dist.Plan().train_step(cfg, device=dev)
    params, opt = init(0)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    leaves = tbench.leaves(params)
    check(sum(t.numel() for t in leaves) == n, "moe: parameter count")
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(weight_bytes == W, f"moe: weights {weight_bytes} B vs {W}")
    batch = tbench.make_batch(cfg, MOE_B, tbench.SEQ, dev)
    _reset_peak(torch, dev)
    out = []
    with tllama.moe_routing() as routing:
        out.append(step(params, opt, batch)[2])
        for w in tbench.KERNELS.values():
            w.launches = 0
        _sync(torch, dev)
        t1 = time.perf_counter()
        for _ in range(MOE_STEPS):
            out.append(step(params, opt, batch)[2])
        _sync(torch, dev)
        dt = (time.perf_counter() - t1) / MOE_STEPS
        losses = [float(m["loss"]) for m in out]
        ces = [float(m["ce"]) for m in out]
        dropped = routing.dropped_share()
    launches = {k: w.launches // MOE_STEPS
                for k, w in tbench.KERNELS.items()}
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 0, "flash_bwd": L, "fused_qkv": 2 * L,
            "fused_attn_epilogue": 2 * L, "fused_mlp_fwd": 0,
            "fused_mlp_bwd_dx": 0}
    check(launches == want and all(
        w.launches % MOE_STEPS == 0 for w in tbench.KERNELS.values()),
        f"moe train launches a step {launches}, expected {want}")
    check(all(math.isfinite(x) for x in losses + ces),
          f"moe losses {losses}, ce {ces}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(ces[0] - ln_v) <= 0.5, f"moe step-0 ce {ces[0]}")
    # the aux a layer, E sum(me ce), is 1 for a uniform router and at
    # most E
    aux0 = (losses[0] - ces[0]) / 0.01
    check(0 < aux0 <= L * cfg.moe_num_experts, f"moe step-0 aux {aux0}")
    check(0 <= dropped < 0.5, f"moe dropped share {dropped}")
    classes = None
    if dev.type == "cuda":
        # where the step's time goes: one more step under the profiler,
        # every device row summed into the train profile's classes (the
        # expert products are cuBLAS batched GEMMs)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(params, opt, batch)
            _sync(torch, dev)
            wall_us = 1e6 * (time.perf_counter() - t1)
        head = f"profile moe train [{card}]: 1 step"
        print_profile(prof, wall_us, head, 20)
        classes = profile_classes(prof, head, {}, {})
    res = dict(step_ms=1e3 * dt, tokens_per_s=MOE_B * tbench.SEQ / dt,
               profile_classes=classes,
               losses=losses, ce=ces, aux_step0=aux0, dropped_share=dropped,
               max_memory_allocated=_peak(torch, dev),
               peak_over_base=_peak(torch, dev) - base,
               weight_bytes=weight_bytes, state_bytes=opt.state_bytes(),
               parameters=n, expert_parameters=n_exp,
               launches_per_step=launches, init_s=init_s)
    print(f"moe train [{card}]: {json.dumps(res)}")
    del params, opt, step, init, batch
    if dev.type == "cuda":
        gc_cuda(torch)
    return res


def moe_dist_rank(steps, device="cuda"):
    """What each rank of ``moe_dist_phase`` runs: the MoE model's step at
    dp=2 (4 experts a rank) on its rows of bench.py's batch, with its
    losses, step times, peak memory, weight and state bytes, kernel
    launches and the collectives of each step beside their reckoning."""
    import torch
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.profiler import metrics
    dev = _device(torch, device)
    cfg = moe_cfg(tllama)
    topo = init_mesh(dp=2)
    step, init = tllama.build_train_step(cfg, topo, device=dev)
    params, opt = init(0)
    batch = step.shard_batch(tbench.make_batch(cfg, MOE_B, tbench.SEQ, dev))
    flags.set_flags({"FLAGS_tpu_metrics": True})
    for w in tbench.KERNELS.values():
        w.launches = 0
    _reset_peak(torch, dev)
    losses, ms, colls = [], [], []
    for _ in range(steps):
        metrics.reset()
        t0 = time.perf_counter()
        losses.append(step(params, opt, batch)[2]["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
        colls.append(collectives_by_op(metrics))
    return dict(coords=topo.coords, losses=losses, step_ms=ms,
                max_memory_allocated=_peak(torch, dev),
                weight_bytes=sum(t.numel() * t.element_size()
                                 for t in tbench.leaves(params)),
                state_bytes=opt.state_bytes(),
                launches={n: w.launches for n, w in tbench.KERNELS.items()},
                collectives=colls,
                reckoned=moe_collective_reckoning(
                    cfg, MOE_B // 2, tbench.SEQ, 2, opt))


def moe_dist_phase(torch, tllama, dist, card, ws1, device="cuda"):
    """The MoE model as 2 gloo ranks on the card at dp=2, its experts
    split over dp (4 a rank), ``MOE_DIST_STEPS`` steps: per-rank weight
    and state bytes against ``moe_reckoning``, losses within
    ``DIST_LOSS_ATOL`` of world size 1's on the same rows (``ws1``:
    ``moe_train_phase``'s), every step's collective calls and bytes by op
    equal to ``moe_collective_reckoning``, rows 7-8 and the flash
    backward launched, rows 9-10 not."""
    t0 = time.perf_counter()
    cfg = moe_cfg(tllama)
    _, _, W, S = moe_reckoning(cfg, dp=2)
    ranks = dist.launch.spawn(moe_dist_rank, 2, (MOE_DIST_STEPS, device),
                       device=device, backend="gloo", timeout=900)
    for r in ranks:
        check(r["weight_bytes"] == W and r["state_bytes"] == S,
              f"moe dp2: weights {r['weight_bytes']} / states "
              f"{r['state_bytes']} vs reckoned {W} / {S}")
        err = max(abs(a - b) for a, b in zip(r["losses"], ws1["losses"]))
        check(err <= DIST_LOSS_ATOL, f"moe dp2: losses {r['losses']} vs "
              f"world size 1 {ws1['losses'][:MOE_DIST_STEPS]}")
        for i, c in enumerate(r["collectives"]):
            check(c == r["reckoned"], f"moe dp2 step {i}: collectives {c} "
                  f"vs the code's count {r['reckoned']}")
        for n in ("fused_qkv", "fused_attn_epilogue", "flash_bwd"):
            check(r["launches"][n] > 0, f"moe dp2: {n} never launched")
        for n in ("fused_mlp_fwd", "fused_mlp_bwd_dx", "flash_fwd"):
            check(r["launches"][n] == 0, f"moe dp2: {n} launched")
    out = dict(ranks=[{k: r[k] for k in (
        "coords", "losses", "step_ms", "max_memory_allocated",
        "weight_bytes", "state_bytes", "launches")} for r in ranks],
        collectives_per_step=ranks[0]["collectives"][0],
        reckoned_weight_bytes=W, reckoned_state_bytes=S,
        loss_err=max(abs(a - b) for r in ranks
                     for a, b in zip(r["losses"], ws1["losses"])),
        seconds=time.perf_counter() - t0)
    print(f"moe dist [{card}]: {json.dumps(out)}")
    return out


MOE_SERVE_RUNS = (("bf16", None), ("int8", "int8"))


def moe_serve_phase(torch, tllama, serving, bench_serve, card,
                    device="cuda"):
    """``LLMEngine`` on the MoE model (random weights from seed 0; the
    engine quantizes at build, which under MoE is ``lm_head`` alone, as
    the reference), 16 requests of 2-24 prompt tokens and 16 new tokens
    (half up front, the rest one every other step), over bf16 and int8
    KV pages: tokens/s, TTFT, step ms, peak memory, and the launches of
    rows 11-13 held to the forwards (row 13 once a forward, rows 11 / 12
    once a layer a forward)."""
    cfg = moe_cfg(tllama)
    L = cfg.num_hidden_layers
    dev = _device(torch, device)
    t0 = time.perf_counter()
    params = tllama.init_params(cfg, 0, device=dev)
    _sync(torch, dev)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             int(rng.integers(2, 25)))]
               for _ in range(16)]
    n_new = 16
    runs = {}
    for name, kv_dtype in MOE_SERVE_RUNS:
        eng = serving.LLMEngine(cfg, params, device=dev, max_running=16,
                                chunk=16, page_size=16, max_model_len=64,
                                kv_dtype=kv_dtype)
        check(isinstance(eng.params["lm_head"], dict) and not isinstance(
            eng.params["layers"]["w_gate"], dict),
            f"moe serve {name}: lm_head int8, the layers dense")
        eng.add_request(prompts[0][:4], 2)          # warm-up
        eng.run()
        _reset_peak(torch, dev)
        eng.clear_samples()
        bench_serve.reset_kernel_launches()
        fw0 = dict(eng.forwards)
        t1 = time.monotonic()
        rids = [eng.add_request(p, n_new) for p in prompts[:8]]
        pending, steps = list(prompts[8:]), 0
        with tllama.moe_routing() as routing:
            while eng.has_work() or pending:
                if pending and steps % 2 == 1:
                    rids.append(eng.add_request(pending.pop(0), n_new))
                eng.step()
                steps += 1
                check(steps < 10000, f"moe serve {name}: no convergence")
            _sync(torch, dev)
            wall = time.monotonic() - t1
            dropped = routing.dropped_share()
        reqs = [eng.request(r) for r in rids]
        check(all(len(r.output) == n_new for r in reqs)
              and all(0 <= t < cfg.vocab_size for r in reqs
                      for t in r.output),
              f"moe serve {name}: a request short or out of the vocabulary")
        check(eng.kv.audit()["ok"], f"moe serve {name}: page books")
        fw = {k: v - fw0[k] for k, v in eng.forwards.items()}
        launches = bench_serve.kernel_launches()
        quant = kv_dtype == "int8"
        want = {"int8_matmul": fw["target"],
                "ragged_paged_attention": 0 if quant else L * fw["target"],
                "ragged_paged_attention_quant": L * fw["target"] if quant
                else 0}
        check(launches == want, f"moe serve {name}: launches {launches} vs "
              f"{want} for the forwards {fw}")
        ttft = sorted(r.first_token_s - r.arrival_s for r in reqs)
        dec = eng._step_wall_s.get(1, [])
        pre = eng._step_wall_s.get(16, [])
        runs[name] = dict(
            tokens_per_s=16 * n_new / wall, wall_s=wall, steps=steps,
            ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
            ttft_max_ms=1e3 * ttft[-1],
            decode_step_ms=1e3 * sum(dec) / len(dec) if dec else None,
            prefill_step_ms=1e3 * sum(pre) / len(pre) if pre else None,
            max_memory_allocated=_peak(torch, dev),
            dropped_share=dropped, forwards=fw, launches=launches)
        print(f"moe serve {name} [{card}]: {json.dumps(runs[name])}")
        del eng
    del params
    if dev.type == "cuda":
        gc_cuda(torch)
    runs["weights_build_s"] = build_s
    return runs


def small_moe_check(torch, tllama, serving):
    """A small MoE model on the card against the CPU's plain path: the
    routing of one MoE layer (``_moe_route``) in f32 on both devices
    (the same experts chosen and kept); one bf16 train step on the card
    (the fused attention block, the flash backward) against f32 on the
    CPU, loss atol 1e-2 (``small_train_check``'s bound); and an f32 MoE
    model with an int8 head served on both devices, equal streams."""
    kw = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=128,
              moe_num_experts=4, remat_policy="dots")
    cfg32 = tllama.LlamaConfig(dtype=torch.float32, **kw)
    base = tllama.init_params(cfg32, 0, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2 * 64, 256)).astype(
        np.float32))
    route = {dev: tllama._moe_route(cfg32, base["layers"]["router"][0].to(
        dev), x.to(dev), 2) for dev in ("cpu", "cuda")}
    for i, what in ((2, "experts"), (3, "kept")):
        check(torch.equal(route["cpu"][i], route["cuda"][i].cpu()),
              f"small moe: the card chose other {what} than the CPU")
    batch = {"input_ids": torch.from_numpy(rng.integers(0, 512, (2, 64))),
             "labels": torch.from_numpy(rng.integers(0, 512, (2, 64)))}
    losses = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        cfg = tllama.LlamaConfig(dtype=dtype, **kw)
        params = _tree(tllama.init_params(
            tllama.LlamaConfig(dtype=torch.bfloat16, **kw), 0,
            device="cpu"), lambda t: t.to(dev, torch.float32 if t.dtype ==
                                          torch.float32 else dtype)
            .requires_grad_())
        total, ce = tllama.loss_fn(cfg, params, _tree(
            batch, lambda t: t.to(dev)))
        total.backward()
        losses[dev] = total.item()
    err = abs(losses["cpu"] - losses["cuda"])
    check(math.isfinite(losses["cuda"]) and err <= 1e-2,
          f"small moe: loss {losses}")
    scfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                              intermediate_size=512, num_hidden_layers=2,
                              num_attention_heads=2, num_key_value_heads=1,
                              max_position_embeddings=128, moe_num_experts=4,
                              dtype=torch.float32, quantized="on")
    sparams = tllama.init_params(scfg, 0, device="cpu")
    prompts = [[int(t) for t in rng.integers(1, 512, 3 + 2 * i)]
               for i in range(6)]
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = serving.LLMEngine(scfg, sparams, device=dev, max_running=4,
                                chunk=8, page_size=16, max_model_len=64)
        rids = [eng.add_request(p, 12) for p in prompts]
        eng.run()
        streams[dev] = [eng.output_of(r) for r in rids]
    check(streams["cpu"] == streams["cuda"],
          f"small moe: the card's streams {streams['cuda']} vs the CPU's "
          f"{streams['cpu']}")
    print(f"small moe check: routing equal (f32, {x.shape[0]} tokens), "
          f"train loss bf16 card {losses['cuda']:.6f} vs f32 CPU "
          f"{losses['cpu']:.6f} (|diff| {err:.3g}, atol 1e-2), 6 streams "
          f"equal (f32, int8 head)")


# ---------------------------------------------------------------------------
# checkpoints, health, the launcher and the gang runtime
# ---------------------------------------------------------------------------

# where the checkpoint phases write (gitignored; removed at the end of
# each phase), apart from chiprun_out/, which holds only small logs
CKPT_ROOT = "_ckpt_smoke"
# bench.py's width at ``BIG_LAYERS`` layers (``main`` passes
# ``big_model``: the depth cut keeps the script inside its time), world
# size 1: 8 steps, a sync save at step 2, an async save at step 4 (steps
# 5-6 run during it), steps 7-8 with the gang's step-boundary snapshot
CKPT_B, CKPT_STEPS = 4, 8
# the gang phase: bench.py's width at 2 layers (the depth cut keeps the
# script inside its time), Plan(dp=2) as 2 gloo ranks on the card, 2
# rows a rank, 4 steps; the chaos run kills rank 1 at step 3's boundary
GANG_LAYERS, GANG_B, GANG_STEPS = 2, 4, 4
GANG_KILL = "kill@collective.all_reduce:step=3,rank=1,restart=0"
GANG_ENV = {"PTQ_GANG_HEARTBEAT_INTERVAL": "1.0",
            "PTQ_GANG_HEARTBEAT_TIMEOUT": "30.0"}
# the train path's kernels: what the new paths must launch (flash_fwd
# runs only unfused; the fused default takes rows 7-10 and flash_bwd)
TRAIN_PATH_KERNELS = ("flash_bwd", "fused_qkv", "fused_attn_epilogue",
                      "fused_mlp_fwd", "fused_mlp_bwd_dx")


def ckpt_reckoning(torch, cfg):
    """(parameters, payload bytes of one train-state checkpoint: the
    weights and AdamW's two moments in the param dtype, plus one f32
    step counter for each of the 12 leaves: embed, the 9 layer leaves,
    norm_f, lm_head)."""
    H, I, L, V = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    n = 2 * V * H + H + L * (4 * H * H + 3 * H * I + 2 * H)
    item = torch.finfo(cfg.dtype).bits // 8
    return n, 3 * n * item + 4 * 12


def _loss_bits(x):
    import struct
    return struct.pack(">f", float(x)).hex()


def _state_equal(torch, got, ref, what):
    """Every leaf of two train-state trees torch.equal (the step
    counters by value)."""
    from paddle_tpu_torch.distributed.reshard import _flat
    g, r = dict(_flat(got)), dict(_flat(ref))
    check(sorted(g) == sorted(r), f"{what}: leaves differ: "
          f"{sorted(set(g) ^ set(r))[:4]}")
    bad = [p for p in r if not (torch.equal(g[p].cpu(), r[p].cpu())
                                if torch.is_tensor(r[p]) else g[p] == r[p])]
    check(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(r)


def _disk_bytes(path):
    return sum(os.path.getsize(os.path.join(b, f))
               for b, _, fs in os.walk(path) for f in fs)


def ckpt_phase(torch, tbench, tllama, dist, card, device="cuda",
               model=None, seq=None, root=CKPT_ROOT):
    """bench.py's shape (S = 2048, B = 4, bf16, "dots", fused "auto") at
    world size 1 through ``Plan().train_step``, saved, restored and
    resumed.  Steps 1-2, ``CheckpointManager.save(2)`` synchronous,
    steps 3-4 (the uninterrupted run); a fresh ``init_fn`` from another
    seed, ``restore()``: every param and moment torch.equal to the
    step-2 state, steps 3-4 bit-identical losses; an async save at step
    4 while steps 5-6 run, ``wait()``, a restore equal to the step-4
    state; steps 7-8 each followed by the gang's step-boundary snapshot
    (what the boundary costs).  Bytes on disk against the reckoning,
    sync stall and GB/s, async stall, step ms during the async save
    against before it, restore s, peak device bytes during the async
    save against the step's; every kernel of the train path launched.
    The free disk space is checked first; the directory is removed at
    the end."""
    import shutil
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed import fault_tolerance as ft
    from paddle_tpu_torch.distributed import reshard
    dev = _device(torch, device)
    cfg = tllama.LlamaConfig(remat_policy="dots",
                             **(model or tbench.MODEL))
    S = seq or tbench.SEQ
    n_params, payload = ckpt_reckoning(torch, cfg)
    os.makedirs(root, exist_ok=True)
    root = os.path.abspath(os.path.join(root, "ws1"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    # two committed steps (keep=3) and one in flight, plus margin
    check(free > 3 * payload + (1 << 30),
          f"ckpt: {free} bytes free under {root}, the phase writes up to "
          f"{3 * payload} (3 checkpoints of {payload})")
    batches = dist_batches(torch, cfg.vocab_size, CKPT_B, S, CKPT_STEPS,
                           dev)
    step_fn, init_fn = dist.Plan().train_step(cfg, device=dev)
    specs = tllama.param_specs(cfg)
    for w in tbench.KERNELS.values():
        w.launches = 0
    res = {"parameters": n_params, "reckoned_bytes": payload,
           "free_bytes": free}

    def run(params, opt, first, last):
        out = []
        for s in range(first, last + 1):
            _sync(torch, dev)
            t0 = time.perf_counter()
            _, _, m = step_fn(params, opt, batches[s - 1])
            loss = m["loss"].item()
            out.append((s, loss, 1e3 * (time.perf_counter() - t0)))
        return out

    # the uninterrupted run, with the synchronous save at step 2
    t_all = time.perf_counter()
    params, opt = init_fn(0)
    check(sum(t.numel() for t in tbench.leaves(params)) == n_params,
          "ckpt: the model's parameters are not the reckoned count")
    ref = run(params, opt, 1, 2)
    mgr = ft.CheckpointManager(root, specs=specs, keep=3)
    t0 = time.perf_counter()
    state2 = reshard.gather_train_state(params, opt)
    t_host = time.perf_counter() - t0
    mgr.save(2, state2, sync=True)
    res["sync_save_s"] = time.perf_counter() - t0
    res["sync_save_host_copy_s"] = t_host
    d2 = os.path.join(root, ft.step_dir_name(2))
    man = ft.verify_dir(d2)
    res["disk_bytes"] = _disk_bytes(d2)
    res["manifest_bytes_total"] = man["bytes_total"]
    res["tensor_bytes"] = ft.tree_bytes(state2)
    check(res["tensor_bytes"] == payload,
          f"ckpt: state tensors {res['tensor_bytes']} B, reckoned {payload}")
    check(0 <= res["disk_bytes"] - payload < (1 << 20),
          f"ckpt: {res['disk_bytes']} bytes on disk for {payload} of "
          f"tensors")
    res["sync_save_gb_s"] = res["disk_bytes"] / res["sync_save_s"] / 1e9
    ref += run(params, opt, 3, 4)
    del params, opt
    if dev.type == "cuda":
        gc_cuda(torch)

    print(f"ckpt [{card}]: uninterrupted run and sync save: "
          f"{json.dumps(res)}", flush=True)

    # resume from a fresh init of another seed: the restore places the
    # params on its tensors' device (the moments go to theirs in
    # load_state_tree)
    params, opt = init_fn(1)
    t0 = time.perf_counter()
    st, got = mgr.restore(target={"params": params, "opt_state": {}})
    res["restore_s"] = time.perf_counter() - t0
    check(got == 2, f"ckpt: restore() gave step {got}, not 2")
    t0 = time.perf_counter()
    params, opt = init_fn(params=st["params"])
    opt.load_state_tree(st["opt_state"])
    _sync(torch, dev)
    res["restore_install_s"] = time.perf_counter() - t0
    check(all(t.device == dev for t in tbench.leaves(params)),
          "ckpt: restored params are not on the card")
    del st
    res["leaves_equal_step2"] = _state_equal(
        torch, reshard.gather_train_state(params, opt), state2,
        "ckpt restore of step 2")
    del state2
    _reset_peak(torch, dev)
    resumed = run(params, opt, 3, 4)
    step_peak = _peak(torch, dev)
    check([_loss_bits(l) for _, l, _ in resumed]
          == [_loss_bits(l) for s, l, _ in ref if s >= 3],
          f"ckpt: resumed losses {resumed} != uninterrupted {ref}")

    # the async save at step 4, steps 5-6 while it writes
    state4 = reshard.gather_train_state(params, opt)
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    mgr.save(4, {"params": params, "opt_state": opt.state_tree()},
             sync=False)
    res["async_save_stall_s"] = time.perf_counter() - t0
    during = run(params, opt, 5, 6)
    t1 = time.perf_counter()
    mgr.wait()
    res["async_wait_s"] = time.perf_counter() - t1
    res["async_save_total_s"] = time.perf_counter() - t0
    res["save_peak_bytes"] = _peak(torch, dev)
    res["step_peak_bytes"] = step_peak
    d4 = os.path.join(root, ft.step_dir_name(4))
    ft.verify_dir(d4)
    t0 = time.perf_counter()
    st4, got = mgr.restore(step=4)
    res["restore4_s"] = time.perf_counter() - t0
    res["leaves_equal_step4"] = _state_equal(torch, st4, state4,
                                             "ckpt async save of step 4")
    del st4, state4

    # the gang's step boundary: a snapshot after each step
    _reset_peak(torch, dev)
    boundary = []
    for s in (7, 8):
        _sync(torch, dev)
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batches[s - 1])
        snap = dckpt.snapshot({"params": params,
                               "opt_state": opt.state_tree()})
        loss = m["loss"].item()
        boundary.append((s, loss, 1e3 * (time.perf_counter() - t0)))
    res["boundary_peak_bytes"] = _peak(torch, dev)
    del snap
    res["launches"] = {n: w.launches for n, w in tbench.KERNELS.items()}
    if dev.type == "cuda":
        bad = [n for n in TRAIN_PATH_KERNELS if not res["launches"][n]]
        check(not bad, f"ckpt: kernels {bad} never launched")
    res["losses_uninterrupted"] = [l for _, l, _ in ref]
    res["losses_resumed"] = [l for _, l, _ in resumed]
    res["loss_bits"] = [_loss_bits(l) for _, l, _ in ref]
    res["step_ms_before"] = [ms for _, _, ms in resumed]
    res["step_ms_during_async"] = [ms for _, _, ms in during]
    res["step_ms_boundary"] = [ms for _, _, ms in boundary]
    res["all_steps_finite"] = all(math.isfinite(l) for _, l, _ in
                                  ref + resumed + during + boundary)
    check(res["all_steps_finite"], "ckpt: a loss is not finite")
    res["ckpt_stats"] = ft.stats()
    res["seconds"] = time.perf_counter() - t_all
    del params, opt
    shutil.rmtree(root, ignore_errors=True)
    if dev.type == "cuda":
        gc_cuda(torch)
    print(f"ckpt [{card}]: {json.dumps(res)}")
    return res


def small_ckpt_check(torch, tllama, dist, device="cuda", root=CKPT_ROOT):
    """A small bf16 model's train state on the card: truncating the
    newest step's state file makes ``restore()`` fall back to the
    previous step (``ckpt_restore_fallback_total`` 1, the restored state
    equal to that step's); ``crash@ckpt.commit.pre`` in a child process
    leaves no visible step and the previous one loads."""
    import shutil
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import fault_tolerance as ft
    from paddle_tpu_torch.distributed import reshard
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.testing import chaos
    dev = _device(torch, device)
    cfg = tllama.LlamaConfig(dtype=torch.bfloat16, remat_policy="dots",
                             **DIST_SMALL)
    root = os.path.abspath(os.path.join(root, "small"))
    shutil.rmtree(root, ignore_errors=True)
    step_fn, init_fn = dist.Plan().train_step(cfg, device=dev)
    params, opt = init_fn(0)
    batches = dist_batches(torch, cfg.vocab_size, 2, 64, 2, dev)
    flags.set_flags({"FLAGS_tpu_metrics": True})
    metrics.reset()
    ft.reset_stats()
    try:
        mgr = ft.CheckpointManager(root, backend="pickle",
                                   specs=tllama.param_specs(cfg))
        states = {}
        for s in (1, 2):
            step_fn(params, opt, batches[s - 1])
            states[s] = reshard.gather_train_state(params, opt)
            mgr.save(s, states[s])
        chaos.truncate_file(os.path.join(root, ft.step_dir_name(2),
                                         mgr.state_file))
        st, got = mgr.restore()
        fallbacks = metrics.snapshot().get("ckpt_restore_fallback_total")
        check(got == 1 and fallbacks == 1,
              f"small ckpt: restore after truncation gave step {got}, "
              f"ckpt_restore_fallback_total {fallbacks}")
        _state_equal(torch, st, states[1], "small ckpt fallback")
        # a save that crashes before its commit rename, in a child
        crash_root = os.path.join(root, "crash")
        mgr2 = ft.CheckpointManager(crash_root, backend="pickle")
        mgr2.save(1, states[1])
        code = ("import torch; from paddle_tpu_torch.distributed import "
                "fault_tolerance as ft; ft.CheckpointManager("
                f"{crash_root!r}, backend='pickle').save(2, "
                "{'w': torch.ones(4)})")
        env = dict(os.environ, PTQ_CHAOS="crash@ckpt.commit.pre:step=2")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        check(proc.returncode == 42,
              f"small ckpt: the crashing save exited {proc.returncode}: "
              f"{proc.stderr[-500:]}")
        check(ft.committed_steps(crash_root) == [1],
              f"small ckpt: committed after the crash: "
              f"{ft.committed_steps(crash_root)}")
        st, got = mgr2.restore()
        check(got == 1, f"small ckpt: restore after the crash: step {got}")
        _state_equal(torch, st, states[1], "small ckpt after crash")
    finally:
        flags.set_flags({"FLAGS_tpu_metrics": False})
        shutil.rmtree(root, ignore_errors=True)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(f"small ckpt [{where}]: truncated newest step -> fallback to "
          "step 1 "
          "(ckpt_restore_fallback_total 1, state equal); "
          "crash@ckpt.commit.pre in a child -> exit 42, no visible step "
          "2, step 1 restored equal")


def gang_worker(argv):
    """One rank of ``gang_phase``'s pod (``chip_smoke.py --gang-worker
    --steps N --ckpt-root DIR``, started by the launcher):
    ``init_gang``, ``Plan(dp=world).train_step`` (states whole on every
    rank: a survivor's final save needs no peer), restore through
    ``reshard.restore_resharded`` at start, a step boundary after every
    step; one ``GANG_STEP`` line a step (loss and its bits, wall time)
    and ``GANG_DONE`` with the kernel launches.  ``--device cpu
    --hidden H`` rehearses it on the CPU at a tiny float32 width."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--gang-worker", action="store_true")
    ap.add_argument("--steps", type=int, default=GANG_STEPS)
    ap.add_argument("--ckpt-root", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--hidden", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch.distributed import Plan, gang, reshard
    from paddle_tpu_torch.models import llama as tllama
    ctx = gang.init_gang(gang.GangConfig.from_env(ckpt_root=args.ckpt_root),
                         device=args.device)
    dev = ctx.device
    if dev.type == "cpu":
        torch.set_num_threads(1)
    model = dict(tbench.MODEL, num_hidden_layers=GANG_LAYERS)
    S = tbench.SEQ
    if args.hidden:     # a CPU rehearsal's width
        model.update(hidden_size=args.hidden, intermediate_size=2 *
                     args.hidden, vocab_size=256, num_attention_heads=2,
                     num_key_value_heads=2, dtype=torch.float32)
        S = 32
    cfg = tllama.LlamaConfig(remat_policy="dots", **model)
    step_fn, init_fn = Plan(dp=ctx.world_size).train_step(
        cfg, zero=False, device=dev)
    t0 = time.time()
    state, start = reshard.restore_resharded(
        args.ckpt_root, topo=step_fn.plan_topology, device=dev)
    if state is None:
        params, opt = init_fn(0)
    else:
        params, opt = init_fn(params=state["params"])
        opt.load_state_tree(state["opt_state"])
        del state
    restore_s = time.time() - t0
    batches = dist_batches(torch, cfg.vocab_size, GANG_B, S, args.steps,
                           "cpu")
    for w in tbench.KERNELS.values():
        w.launches = 0
    with ctx.running():
        for s in range(start + 1, args.steps + 1):
            t0 = time.time()
            _, _, m = step_fn(params, opt,
                              step_fn.shard_batch(batches[s - 1]))
            loss = m["loss"].item()
            print("GANG_STEP " + json.dumps({
                "rank": ctx.rank, "restart": ctx.restart, "step": s,
                "loss": loss, "bits": _loss_bits(loss), "t": time.time(),
                "ms": 1e3 * (time.time() - t0)}), flush=True)
            ctx.step_boundary(s, params, opt)
    print("GANG_DONE " + json.dumps({
        "rank": ctx.rank, "restart": ctx.restart, "start": start,
        "restore_s": restore_s,
        "launches": {n: w.launches for n, w in tbench.KERNELS.items()},
        "peak": (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else 0)}), flush=True)
    ctx.shutdown(0)
    return 0


def _marked(path, marker):
    out = []
    try:
        with open(path) as f:
            for ln in f:
                if ln.startswith(marker + " "):
                    out.append(json.loads(ln[len(marker) + 1:]))
    except OSError:
        pass
    return out


def _incidents(path):
    try:
        with open(path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return None, []
    return (lines[0] if lines else None), lines[1:]


def gang_pod(torch, run, chaos_spec, steps, extra_args=(), device=None,
             timeout=900):
    """One pod of ``gang_phase``: 2 ranks through ``python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node 2
    --max_restarts 1``; returns its exit code, the ranks' step and done
    records, and the log directory."""
    import shutil
    base = os.path.abspath(os.path.join("chiprun_out", "gang", run))
    ckpt = os.path.abspath(os.path.join(CKPT_ROOT, f"gang_{run}"))
    shutil.rmtree(base, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    log = os.path.join(base, "log")
    env = dict(os.environ, **GANG_ENV)
    env.pop("PTQ_CHAOS", None)
    if chaos_spec:
        env["PTQ_CHAOS"] = chaos_spec
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--max_restarts", "1",
           "--teardown_grace", "120", "--log_dir", log,
           os.path.abspath(__file__), "--gang-worker", "--steps",
           str(steps), "--ckpt-root", ckpt, *extra_args]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    steps_, done = [], []
    for r in (0, 1):
        steps_ += _marked(os.path.join(log, f"workerlog.{r}"), "GANG_STEP")
        done += _marked(os.path.join(log, f"workerlog.{r}"), "GANG_DONE")
    man = None
    for d in sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []:
        from paddle_tpu_torch.distributed import fault_tolerance as ft
        man = ft.read_manifest(os.path.join(ckpt, d)) or man
    return dict(rc=proc.returncode, steps=steps_, done=done, log=log,
                wall_s=wall, stderr=proc.stderr[-3000:], manifest=man,
                ckpt=ckpt)


def gang_clean_job(torch, device=None, extra_args=()):
    """``beside``'s job for ``gang_phase``'s uninterrupted pod."""
    return functools.partial(gang_pod, torch, "clean", None, GANG_STEPS,
                             extra_args, device)


def gang_phase(torch, card, clean, device=None, extra_args=()):
    """Two ranks of bench.py's width at ``GANG_LAYERS`` layers on the one
    card over gloo (``Plan(dp=2)``, 2 rows a rank, S = 2048), through
    the launcher: ``clean``, an uninterrupted pod (``gang_clean_job``'s
    result), then, run here alone, a pod whose rank 1 is killed
    (``os._exit``, process-kill mode) at step 3's boundary.  The chaos
    pod must exit 0; the survivor's incident sidecar must hold
    ``health_exit`` (or ``rank_dead``); generation 1 must resume after
    step 3; every step's loss must be bit-identical to the uninterrupted
    pod's.  Detection s (the kill to the survivor's conversion),
    final-save s and bytes, recovery s (the kill to generation 1's first
    finished step), steps lost."""
    import shutil
    t_all = time.perf_counter()
    check(clean["rc"] == 0, f"gang clean pod exited {clean['rc']}: "
          f"{clean['stderr']}")
    ref = {}
    for r in clean["steps"]:
        ref.setdefault(r["step"], set()).add(r["bits"])
    check(sorted(ref) == list(range(1, GANG_STEPS + 1))
          and all(len(b) == 1 for b in ref.values()),
          f"gang clean pod: steps/bits {ref}")
    kill = gang_pod(torch, "kill", GANG_KILL, GANG_STEPS, extra_args,
                    device)
    check(kill["rc"] == 0, f"gang chaos pod exited {kill['rc']}: "
          f"{kill['stderr']}")
    gen0 = [r for r in kill["steps"] if r["restart"] == 0]
    gen1 = [r for r in kill["steps"] if r["restart"] == 1]
    check({r["step"] for r in gen0} == {1, 2, 3},
          f"gang chaos pod: generation 0 ran steps "
          f"{sorted({r['step'] for r in gen0})}")
    check({r["step"] for r in gen1} == set(range(4, GANG_STEPS + 1)),
          f"gang chaos pod: generation 1 ran steps "
          f"{sorted({r['step'] for r in gen1})}, not 4..{GANG_STEPS}")
    bad = [r for r in kill["steps"] if {r["bits"]} != ref[r["step"]]]
    check(not bad, f"gang chaos pod: losses differ from the clean pod: "
          f"{bad[:3]}")
    header, incs = _incidents(os.path.join(kill["log"],
                                           "incidents_rank0.jsonl"))
    kinds = {i["kind"] for i in incs}
    check(kinds & {"health_exit", "rank_dead"},
          f"gang chaos pod: survivor's incidents {sorted(kinds)}")
    t_kill = next(r["t"] for r in gen0 if r["rank"] == 1 and r["step"] == 3)
    t_conv = min(i["time"] for i in incs if i["kind"] == "health_exit")
    man = kill["manifest"]
    check(man is not None and man.get("step") == 3,
          f"gang chaos pod: final save manifest {man and man.get('step')}")
    res = {
        "clean_losses": [next(r["loss"] for r in clean["steps"]
                              if r["step"] == s)
                         for s in range(1, GANG_STEPS + 1)],
        "clean_step_ms": {r["rank"]: [x["ms"] for x in clean["steps"]
                                      if x["rank"] == r["rank"]]
                          for r in clean["done"]},
        "clean_wall_s": clean["wall_s"], "kill_wall_s": kill["wall_s"],
        "survivor_incidents": sorted(kinds),
        "detection_s": t_conv - t_kill,
        "final_save_s": header["wall_time"] - t_conv,
        "final_save_bytes": man["bytes_total"],
        "recovery_s": min(r["t"] for r in gen1) - t_kill,
        "steps_lost": max(r["step"] for r in gen0) - 3,
        "resumed_from": sorted({d["start"] for d in kill["done"]}),
        "gen1_restore_s": [d["restore_s"] for d in kill["done"]],
        "launches_rank0_clean": next(d["launches"] for d in clean["done"]
                                     if d["rank"] == 0),
        "peak_rank0_clean": next(d["peak"] for d in clean["done"]
                                 if d["rank"] == 0),
        "seconds": clean["wall_s"] + time.perf_counter() - t_all,
    }
    check(res["resumed_from"] == [3],
          f"gang chaos pod: generation 1 restored {res['resumed_from']}")
    if device != "cpu":
        bad = [n for n in TRAIN_PATH_KERNELS
               if not res["launches_rank0_clean"][n]]
        check(not bad, f"gang: kernels {bad} never launched")
    for p in (clean["ckpt"], kill["ckpt"]):
        shutil.rmtree(p, ignore_errors=True)
    print(f"gang [{card}]: {json.dumps(res)}")
    return res


def gang_bench_line(card, device=None):
    """``python -m paddle_tpu_torch.bench --multichip --gang 2``: the
    gang preset (pp=2 1F1B) as 2 processes through the launcher, trace
    on; both ranks' losses equal, the recorded schedules the static
    one."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.bench", "--multichip",
           "--gang", "2", "--trace-out", "chiprun_out/gang_bench_trace"]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ)
    env.pop("PTQ_CHAOS", None)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else "{}"
    res = json.loads(line)
    check(proc.returncode == 0 and "error" not in res,
          f"bench --gang 2: rc {proc.returncode}: {line[-1500:]} "
          f"{proc.stderr[-1500:]}")
    det = res["detail"]
    # the bench itself fails a rank whose losses differ from rank 0's
    check(det["matches_static"] == [True, True],
          f"bench --gang 2: matches_static {det['matches_static']}")
    check(all(math.isfinite(x) for x in det["losses"]),
          f"bench --gang 2: losses {det['losses']}")
    print(f"gang bench [{card}] ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(res))
    return res


# the training loop around the step (train_loop_phase): a token dataset
# of 64 samples of S + 1 tokens, 4 rows a step through
# DistributedBatchSampler -> DataLoader (2 workers) -> DeviceDataLoader
# (2 batches ahead), a sync save at step 2, step 4's loss replaced by NaN
# (RewindGuard restores step 2 and skips batches 3-4), 8 steps; the
# Profiler records steps 5-6 of its count; localize with layer 3's wq
# poisoned
LOOP_SAMPLES, LOOP_B, LOOP_STEPS = 64, 4, 8
LOOP_SAVE, LOOP_NAN, LOOP_WORKERS = 2, 4, 2
LOOP_PROFILE = (5, 7)
LOOP_POISON_LAYER = 3
# the CUDA kernels of rows 1-10 as the profiler names them (rows 1-2 the
# flash forward, 3-6 the flash backward, 7-9 the TMA GEMM's
# instantiations, 10 the gate/up gradient kernel)
LOOP_TRACE_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel",
                      "gemm_tma_kernel", "gate_up_grad_kernel")
# the in-process resize (resize_phase): bench.py's width at GANG_LAYERS
# layers, Plan(dp=2) as 2 gloo ranks through the launcher over 6 global
# batches of 4 rows from a DataLoader, request_scale(..., 1) before step 3
RESIZE_STEPS, RESIZE_AT = 6, 3


class TokenData:
    """A seeded token dataset in host memory: ``n`` samples of S + 1
    tokens; sample i is its next-token pair and its id."""

    def __init__(self, n, S, vocab, seed):
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, vocab, (n, S + 1), dtype=np.int64)

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        row = self.tokens[i]
        return {"input_ids": row[:-1], "labels": row[1:], "ids": np.int64(i)}

    def batch(self, torch, ids, device):
        rows = self.tokens[ids]
        return {"input_ids": torch.from_numpy(rows[:, :-1]).to(device),
                "labels": torch.from_numpy(rows[:, 1:]).to(device)}


def _pair(b):
    return {"input_ids": b["input_ids"], "labels": b["labels"]}


def device_init_line(watchdog, card_probe=None):
    """``runtime.watchdog.init_with_retries`` over a real init of the card
    (``probe_device``: init, one launch, synchronize): its attempts and
    seconds on a line of their own; fails the run when the window runs
    out."""
    t0 = time.perf_counter()
    ok, attempts, err = watchdog.init_with_retries(
        card_probe or watchdog.probe_device, window_s=120.0, base_delay=5.0,
        log=lambda m: print(f"device init: {m}", flush=True))
    secs = time.perf_counter() - t0
    print(f"device init: init_with_retries ok={ok} after {attempts} "
          f"attempt(s) in {secs:.3f} s", flush=True)
    check(ok, f"device init failed: {err}")
    return {"attempts": attempts, "seconds": secs}


def train_loop_phase(torch, tbench, tllama, dist, card, build_report=None,
                     device="cuda", model=None, seq=None, root=CKPT_ROOT,
                     workers=LOOP_WORKERS):
    """bench.py's shape (S = 2048, B = 4, bf16, "dots", fused "auto") at
    world size 1 through ``Plan().train_step``, fed by the port's data
    pipeline and guarded by ``RewindGuard``, under the ``Profiler`` with
    FLAGS_tpu_xmem, FLAGS_tpu_check_nan_inf and FLAGS_tpu_metrics on.

    ``TokenData`` (64 samples) -> ``DistributedBatchSampler(4, 1 replica,
    shuffle)`` -> ``DataLoader(num_workers=2, places=card)``, which hands
    off to ``DeviceDataLoader(buffer_size=2)`` inside it (the cursor then
    counts the batches the step took).  A ``CheckpointManager`` with the
    loader attached saves step 2 synchronously; step 4's loss is replaced
    by NaN; the guard restores step 2 and skips batches 3-4; the loop runs
    on to step 8.  From the rewind on, each step of the loop (A) runs in
    turn with the same step of a second state restored from step 2 (B)
    on the same batches already on the card: B is the uninterrupted run
    from step 2, and its losses must equal A's bit for bit.  Checks: the
    consumed ids ``order[:8] + order[16:40]``; one ``anomaly_rewind``
    incident; ``rewind_total`` 1 and ``rewind_skipped_batches_total`` 2;
    the exported trace holds ``dataloader_next`` spans and the kernels of
    rows 1-10; the summary's Compilation, Memory and Numerics sections
    hold numbers; ``numerics.localize`` of one step with layer 3's ``wq``
    set to 1e38 names layer 3's ``fused_qkv``.  Reports the step ms of A
    (next batch + step) and B (step), the ``dataloader_next`` waits, the
    save, restore and rewind seconds, the step's peak beside xmem's.
    The fed steps' statistic (``fed_steady``) leaves out each
    iterator's first batch, whose wait holds the workers' start
    (``fed_first_ms``)."""
    import shutil
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.distributed import fault_tolerance as ft
    from paddle_tpu_torch.distributed import reshard
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.profiler import (Profiler, compile_tracker,
                                           metrics, numerics, xmem)
    from paddle_tpu_torch.runtime import RewindGuard, watchdog
    t_all = time.perf_counter()
    dev = _device(torch, device)
    cfg = tllama.LlamaConfig(remat_policy="dots", **(model or tbench.MODEL))
    S = seq or tbench.SEQ
    root = os.path.abspath(os.path.join(root, "loop"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    trace_dir = os.path.abspath(os.path.join("chiprun_out",
                                             "train_loop_trace"))
    shutil.rmtree(trace_dir, ignore_errors=True)
    flags.set_flags({"FLAGS_tpu_xmem": True,
                     "FLAGS_tpu_check_nan_inf": True,
                     "FLAGS_tpu_metrics": True})
    metrics.reset()
    numerics.reset()
    xmem.reset()
    watchdog.clear_incidents()
    for n, r in (build_report or {}).items():
        for kernel, use in _build.ptxas_usage(r["log"]).items():
            xmem.record_kernel_estimate(kernel, use["smem_bytes"], where=n,
                                        registers=use["registers"])
    data = TokenData(LOOP_SAMPLES, S, cfg.vocab_size, seed=0)
    smp = tio.DistributedBatchSampler(data, LOOP_B, num_replicas=1, rank=0,
                                      shuffle=True, seed=0)
    order = smp._global_order(0)
    loader = tio.DataLoader(data, batch_sampler=smp, num_workers=workers,
                            places=dev, prefetch_factor=2)
    step_fn, init_fn = dist.Plan().train_step(cfg, device=dev)
    specs = tllama.param_specs(cfg)
    mgr = ft.CheckpointManager(root, specs=specs, keep=3).attach_data(loader)
    params, opt = init_fn(0)
    guard = RewindGuard(mgr, data=loader, max_rewinds=1,
                        restore_target={"params": params, "opt_state": {}})
    res = {"ms_loader": [], "ms_on_card": [], "ms_before": [],
           "next_wait_ms": [], "first_of_iter": []}
    consumed, losses_a, losses_b = [], {}, {}
    state_b = batches_b = None
    for w in tbench.KERNELS.values():
        w.launches = 0
    step, it, fresh = 0, iter(loader), True
    prof = Profiler(scheduler=LOOP_PROFILE)
    prof.start()
    try:
        while step < LOOP_STEPS:
            _sync(torch, dev)
            t0 = time.perf_counter()
            batch = next(it)
            res["next_wait_ms"].append(1e3 * (time.perf_counter() - t0))
            first, fresh = fresh, False
            step += 1
            if step == 2:
                _reset_peak(torch, dev)
            _, _, m = step_fn(params, opt, _pair(batch))
            loss = m["loss"].item()
            ms = 1e3 * (time.perf_counter() - t0)
            if step == 2:
                res["step_peak_bytes"] = _peak(torch, dev)
            ids = batch["ids"].tolist()
            if step == LOOP_NAN and guard.rewinds == 0:
                loss = float("nan")       # the poisoned batch
            numerics.note("train_loss", loss)
            numerics.check_array(np.float32(loss), "train.step.loss",
                                 action="collect")
            t0 = time.perf_counter()
            rw = guard.check(step, loss)
            if rw is not None:
                res["rewind_s"] = time.perf_counter() - t0
                it.close()
                del params, opt, batch, m
                t0 = time.perf_counter()
                params, opt = init_fn(params=rw.state["params"])
                opt.load_state_tree(rw.state["opt_state"])
                del rw.state
                _sync(torch, dev)
                res["rewind_install_s"] = time.perf_counter() - t0
                res["rewind"] = {"restored_step": rw.step,
                                 "anomaly_step": rw.anomaly_step,
                                 "skipped_batches": rw.skipped_batches,
                                 "reason": rw.reason}
                step = rw.step
                # the steps past the restored one are undone
                consumed = consumed[:step * LOOP_B]
                # B: the uninterrupted run from the step-2 state, on the
                # batches A takes next, already on the card
                t0 = time.perf_counter()
                st, got = mgr.restore(
                    target={"params": params, "opt_state": {}},
                    step=LOOP_SAVE, apply_data=False, apply_rng=False)
                state_b = init_fn(params=st["params"])
                state_b[1].load_state_tree(st["opt_state"])
                del st
                _sync(torch, dev)
                res["restore_s"] = time.perf_counter() - t0
                # step s after the rewind takes the (s - step)-th batch
                # past the skipped window
                first = (rw.step + rw.skipped_batches) * LOOP_B
                batches_b = {
                    s: data.batch(torch, order[
                        first + (s - rw.step - 1) * LOOP_B:
                        first + (s - rw.step) * LOOP_B], dev)
                    for s in range(rw.step + 1, LOOP_STEPS + 1)}
                guard.restore_target = {"params": params, "opt_state": {}}
                it, fresh = iter(loader), True
                prof.step()
                continue
            consumed += ids
            losses_a[step] = loss
            (res["ms_loader"] if state_b is not None
             else res["ms_before"]).append(ms)
            if state_b is not None:
                res["first_of_iter"].append(first)
                _sync(torch, dev)
                t0 = time.perf_counter()
                _, _, mb = step_fn(*state_b, batches_b[step])
                losses_b[step] = mb["loss"].item()
                res["ms_on_card"].append(1e3 * (time.perf_counter() - t0))
            if step == LOOP_SAVE:
                t0 = time.perf_counter()
                mgr.save(step, reshard.gather_train_state(params, opt),
                         sync=True)
                res["save_s"] = time.perf_counter() - t0
                res["save_bytes"] = _disk_bytes(
                    os.path.join(root, ft.step_dir_name(step)))
            prof.step()
    finally:
        prof.stop()
        it.close()
    res["launches"] = {n: w.launches for n, w in tbench.KERNELS.items()}
    res["loop_s"] = time.perf_counter() - t_all
    # A fed by the loader against B on the card, over the steps after
    # the rewind whose batch was not the new iterator's first
    steady = [(a, b) for a, b, f in zip(res["ms_loader"], res["ms_on_card"],
                                        res["first_of_iter"]) if not f]
    fed, on_card = [a for a, _ in steady], [b for _, b in steady]
    res["fed_first_ms"] = [a for a, f in zip(res["ms_loader"],
                                             res["first_of_iter"]) if f]
    res["fed_steady"] = {
        "steps": len(steady), "fed_median_ms": float(np.median(fed)),
        "fed_min_ms": min(fed), "fed_max_ms": max(fed),
        "on_card_median_ms": float(np.median(on_card)),
        "on_card_min_ms": min(on_card), "on_card_max_ms": max(on_card),
        "fed_over_on_card_pct": 100.0 * (float(np.median(fed))
                                         / float(np.median(on_card)) - 1)}
    check(consumed == order[:LOOP_SAVE * LOOP_B]
          + order[(LOOP_NAN * LOOP_B):(LOOP_NAN + LOOP_STEPS - LOOP_SAVE)
                  * LOOP_B],
          f"train loop: consumed ids {consumed} are not order[:8] + "
          f"order[16:40]")
    bits_a = {s: _loss_bits(l) for s, l in losses_a.items()
              if s > LOOP_SAVE}
    bits_b = {s: _loss_bits(l) for s, l in losses_b.items()}
    check(bits_a == bits_b and sorted(bits_b) == list(
        range(LOOP_SAVE + 1, LOOP_STEPS + 1)),
          f"train loop: losses after the rewind {losses_a} differ from the "
          f"uninterrupted run from step {LOOP_SAVE} {losses_b}")
    rewinds = [i for i in watchdog.incidents()
               if i["kind"] == "anomaly_rewind"]
    check(len(rewinds) == 1 and rewinds[0]["restored_step"] == LOOP_SAVE
          and rewinds[0]["skipped_batches"] == LOOP_NAN - LOOP_SAVE,
          f"train loop: anomaly_rewind incidents {rewinds}")
    snap = metrics.snapshot()
    res["metrics"] = {k: snap.get(k) for k in (
        "rewind_total", "rewind_skipped_batches_total",
        "dataloader_batches_total")}
    check(snap.get("rewind_total") == 1
          and snap.get("rewind_skipped_batches_total") == 2,
          f"train loop: rewind metrics {res['metrics']}")
    # the trace: host spans and the card's kernels of the recorded steps
    path = prof.export(os.path.join(trace_dir, "loop.pt.trace.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    names = {e["name"] for e in evs if e.get("ph") == "X"}
    res["trace_events"] = len(evs)
    res["trace_dataloader_next"] = sum(
        1 for e in evs if e.get("name") == "dataloader_next")
    check(res["trace_dataloader_next"] >= 2,
          "train loop: no dataloader_next spans in the exported trace")
    if dev.type == "cuda":
        missing = [k for k in LOOP_TRACE_KERNELS
                   if not any(k in n for n in names)]
        check(not missing, f"train loop: the trace lacks {missing}")
        res["trace_kernels"] = sorted(
            {n for n in names if any(k in n for k in LOOP_TRACE_KERNELS
                                     + ("rms_norm",))})[:12]
        bad = [n for n in TRAIN_PATH_KERNELS if not res["launches"][n]]
        check(not bad, f"train loop: kernels {bad} never launched")
    table = prof.summary_table()
    print(f"train loop [{card}]: Profiler.summary_table():\n{table}",
          flush=True)
    sect = {}
    for head in ("Compilation", "Memory", "Numerics"):
        lines = table.split(head, 1)[1].split("-----", 1)[0].splitlines()
        sect[head] = [ln for ln in lines[1:] if ln.strip()]
    built = (compile_tracker.stats()["compile_count"]
             + compile_tracker.stats()["persistent_cache_hits"])
    check((built > 0 or dev.type != "cuda")
          and xmem.stats()["executables"] >= 1
          and numerics.sites().get("train.step.loss", {}).get(
              "nonfinite") == 1,
          f"train loop: summary sections {sect}")
    cap = next(p for p in xmem.profiles() if p["name"] == "train_step")
    res["xmem"] = {k: cap[k] for k in (
        "peak_bytes", "device_peak_bytes", "temp_bytes", "argument_bytes",
        "output_bytes", "flops")}
    res["span_stats"] = {n: {"calls": c, "total_ms": 1e3 * t,
                             "max_ms": 1e3 * mx}
                         for n, (c, t, mx) in prof._span_stats.items()}
    res["compile"] = {k: v for k, v in compile_tracker.stats().items()
                      if k != "sources"}
    del state_b, batches_b
    # localize: one step with layer 3's wq poisoned, in a copy
    bad = dict(params)
    bad["layers"] = dict(params["layers"])
    wq = params["layers"]["wq"].detach().clone()
    wq[LOOP_POISON_LAYER] = 1e38
    bad["layers"]["wq"] = wq
    del params, opt
    if dev.type == "cuda":
        gc_cuda(torch)
    flags.set_flags({"FLAGS_tpu_xmem": False})
    p_bad, o_bad = init_fn(params=bad)
    del bad, wq
    ids0 = order[:LOOP_B]
    b0 = data.batch(torch, ids0, dev)
    t0 = time.perf_counter()
    rep = numerics.localize(lambda: step_fn(p_bad, o_bad, b0))
    res["localize_s"] = time.perf_counter() - t0
    res["localize"] = {k: rep.get(k) for k in (
        "primitive", "kind", "call_index", "op_index", "where", "nan",
        "inf", "size")} if rep else None
    if dev.type == "cuda":
        check(rep is not None and rep["primitive"] == "fused_qkv"
              and rep["call_index"] == LOOP_POISON_LAYER,
              f"train loop: localize named {res['localize']}, not layer "
              f"{LOOP_POISON_LAYER}'s fused_qkv")
    else:
        check(rep is not None, "train loop: localize found nothing")
    del p_bad, o_bad
    flags.set_flags({"FLAGS_tpu_check_nan_inf": False,
                     "FLAGS_tpu_metrics": False})
    metrics.reset()
    shutil.rmtree(root, ignore_errors=True)
    if dev.type == "cuda":
        gc_cuda(torch)
    res["seconds"] = time.perf_counter() - t_all
    res["losses"] = [losses_a[s] for s in sorted(losses_a)]
    print(f"train loop [{card}]: {json.dumps(res)}", flush=True)
    return res


def resize_worker(argv):
    """One rank of ``resize_phase``'s pod (``chip_smoke.py
    --resize-worker --ckpt-root DIR``, started by the launcher): joins the
    process group over gloo on the card, runs ``Plan(dp=world)
    .run_train_loop`` over ``RESIZE_STEPS`` global batches of a
    ``DataLoader`` with rank 0's feed writing ``request_scale(..., 1)``
    before step ``RESIZE_AT``; one ``RESIZE_DONE`` line with its history,
    the ids of the batches it trained on and its kernel launches.  Rank 0
    also holds the resize's state against the state it saved: the state
    gathered whole after step ``RESIZE_AT`` (``pre``) against the
    checkpoint on disk, leaf by leaf; and its own losses after the resize
    against steps from ``pre`` at world size 1 on the same batches, bit
    for bit (``restore``).  Two controls run the same steps from the
    init params and from ``pre`` with AdamW's moments zeroed, and must
    differ.  ``--device cpu --hidden H`` rehearses it on the CPU."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--resize-worker", action="store_true")
    ap.add_argument("--ckpt-root", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--hidden", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed import Plan, reshard
    from paddle_tpu_torch.distributed.fault_tolerance import step_dir_name
    from paddle_tpu_torch.distributed.fleet.elastic import request_scale
    from paddle_tpu_torch.framework.io import load as fload
    from paddle_tpu_torch.distributed.store import (TCPStore,
                                                    init_parallel_env,
                                                    shutdown)
    from paddle_tpu_torch.models import llama as tllama
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    dev = resolve_device(args.device)
    store = TCPStore(host, int(port), False, world, 300.0)
    init_parallel_env(dev, backend="gloo", store=store, rank=rank,
                      world_size=world, timeout=300.0)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg, S = resize_cfg(torch, tbench, tllama, args.hidden)
    loader = resize_loader(tio, cfg, S)
    took, last, tail, pre = [], {}, [], {}

    def feed():
        for i, b in enumerate(loader):
            if i == RESIZE_STEPS:
                break
            if i == RESIZE_AT and rank == 0:
                request_scale("", "resize", 1, store=store)
            last["ids"] = b["ids"].tolist()
            if i >= RESIZE_AT and rank == 0:
                tail.append(_pair(b))
            yield _pair(b)

    def on_step(n, params, opt):
        took.append(last["ids"])
        if n == RESIZE_AT:      # collective: both ranks gather
            st = reshard.gather_train_state(params, opt)
            if rank == 0:
                pre["state"] = st
            del st
        print("RESIZE_STEP " + json.dumps({
            "rank": rank, "step": n, "t": time.time()}), flush=True)

    for w in tbench.KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    hist = Plan(dp=world).run_train_loop(
        cfg, feed(), seed=0, job_id="resize", scale_store=store,
        ckpt_root=args.ckpt_root, on_step=on_step, device=dev)
    seconds = time.perf_counter() - t0
    # the loop's launches and peak, before the check's steps add theirs
    launches = {n: w.launches for n, w in tbench.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    restore = (resize_restore_check(torch, Plan, cfg, dev, pre.pop(
        "state"), fload(os.path.join(args.ckpt_root, step_dir_name(
            RESIZE_AT), "state.pdz")), tail, hist["losses"][RESIZE_AT:])
        if rank == 0 else None)
    print("RESIZE_DONE " + json.dumps({
        "rank": rank, "losses": hist["losses"], "restore": restore,
        "world_sizes": hist["world_sizes"], "resizes": hist["resizes"],
        "resize_stats": hist["resize_stats"], "ids": took,
        "seconds": seconds, "launches": launches, "peak": peak}),
        flush=True)
    shutdown()
    return 0


def resize_restore_check(torch, Plan, cfg, dev, pre, saved, tail, losses):
    """What a resize at world size 1 continued from, told apart from
    what it should have: ``pre`` (the state gathered before the save)
    against ``saved`` (the checkpoint), leaf by leaf; then steps over
    ``tail`` at world size 1 from ``pre``, from the init params and from
    ``pre`` with zeroed moments, each loss against ``losses`` (rank 0's
    after the resize) as float32 bits and as the largest difference."""
    from paddle_tpu_torch.distributed.reshard import _flat
    a, b = dict(_flat(pre)), dict(_flat(saved))
    differ = sorted(p for p in a if p not in b or not (
        torch.equal(a[p].cpu(), b[p].cpu()) if torch.is_tensor(a[p])
        else a[p] == b[p]))
    out = {"leaves": len(a), "saved_differ": differ[:4] + (
        ["missing"] if sorted(a) != sorted(b) else []),
        "saved_differ_count": len(differ)}
    del saved, a, b

    def zeroed(tree):
        return {p: {k: (torch.zeros_like(v) if torch.is_tensor(v)
                        and v.dim() > 0 else v) for k, v in st.items()}
                for p, st in tree.items()}

    step_fn, init_fn = Plan().train_step(cfg, device=dev, ranks=1)
    for name, moments in (("restore", pre["opt_state"]),
                          ("from_init", None),
                          ("zeroed_moments", zeroed(pre["opt_state"]))):
        if moments is None:
            params, opt = init_fn(0)
        else:
            params, opt = init_fn(params=_tree(
                pre["params"], lambda t: t.to(dev, copy=True)))
            opt.load_state_tree(moments)
        got = []
        for b in tail:
            params, opt, m = step_fn(params, opt, step_fn.shard_batch(b))
            got.append(m["loss"].item())
        out[name] = {
            "losses": got,
            "bit_equal": [_loss_bits(x) for x in got]
            == [_loss_bits(x) for x in losses],
            "max_abs_diff": max(abs(x - y) for x, y in zip(got, losses))}
        del params, opt
    return out


def resize_cfg(torch, tbench, tllama, hidden=None):
    model = dict(tbench.MODEL, num_hidden_layers=GANG_LAYERS)
    S = tbench.SEQ
    if hidden:     # a CPU rehearsal's width
        model.update(hidden_size=hidden, intermediate_size=2 * hidden,
                     vocab_size=256, num_attention_heads=2,
                     num_key_value_heads=2, dtype=torch.float32)
        S = 32
    return tllama.LlamaConfig(remat_policy="dots", **model), S


def resize_loader(tio, cfg, S):
    """The global batches: ``GANG_B`` rows a step from one replica's
    ``DistributedBatchSampler`` (the global order), in a ``DataLoader``."""
    data = TokenData(LOOP_SAMPLES, S, cfg.vocab_size, seed=1)
    smp = tio.DistributedBatchSampler(data, GANG_B, num_replicas=1, rank=0,
                                      shuffle=True, seed=1)
    return tio.DataLoader(data, batch_sampler=smp)


def resize_pod(device=None, extra_args=()):
    """``resize_phase``'s pod, a job for ``beside``: two gloo ranks of
    ``chip_smoke.py --resize-worker`` on the one card through the
    launcher (as ``gang_phase``'s pods).  Returns its exit code, its
    stderr's tail, the ranks' done records and its wall seconds."""
    base = os.path.abspath(os.path.join("chiprun_out", "resize"))
    ckpt = os.path.abspath(os.path.join(CKPT_ROOT, "resize"))
    shutil.rmtree(base, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    log = os.path.join(base, "log")
    env = dict(os.environ)
    env.pop("PTQ_CHAOS", None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--max_restarts", "0", "--log_dir", log,
           os.path.abspath(__file__), "--resize-worker", "--ckpt-root", ckpt,
           *extra_args]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    done = {}
    for r in (0, 1):
        for d in _marked(os.path.join(log, f"workerlog.{r}"), "RESIZE_DONE"):
            done[d["rank"]] = d
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(rc=proc.returncode, stderr=proc.stderr[-3000:], done=done,
                wall_s=wall)


def resize_phase(torch, tbench, tllama, dist, card, pod, device=None,
                 extra_args=()):
    """``pod``: ``resize_pod``'s result, at the same ``device`` and
    ``extra_args``.  Its two gloo ranks run ``Plan(dp=2).run_train_loop``
    at bench.py's width and ``GANG_LAYERS`` layers over 6 global batches
    of 4 rows from a ``DataLoader``, ``request_scale(..., 1)`` before
    step 3.  Checks:
    rank 0's ``world_sizes`` [2, 2, 2, 1, 1, 1] and ``resizes`` [(3, 2,
    1)]; the pod (both processes) exits 0, rank 1 with steps 1-3; rank
    0's losses within ``DIST_LOSS_ATOL`` of world size 1 over the same
    batches (``Plan().run_train_loop`` in this process); rank 0's state
    as saved equal leaf by leaf to the state gathered before the save,
    and its losses after the resize bit-equal to steps from that state
    (``resize_restore_check``), which the init params and zeroed
    moments are not; no sample replayed or skipped (rank 0 trained on
    the loader's first 6 batches in order).  Reports the resize's save,
    group and restore seconds, the bytes saved and the controls'
    differences."""
    from paddle_tpu_torch import io as tio
    t_all = time.perf_counter()
    done, wall = pod["done"], pod["wall_s"]
    check(pod["rc"] == 0 and sorted(done) == [0, 1],
          f"resize pod exited {pod['rc']}, done {sorted(done)}: "
          f"{pod['stderr']}")
    r0, r1 = done[0], done[1]
    check(r0["world_sizes"] == [2] * RESIZE_AT + [1] * (RESIZE_STEPS
                                                        - RESIZE_AT)
          and [tuple(x) for x in r0["resizes"]] == [(RESIZE_AT, 2, 1)],
          f"resize: rank 0 world sizes {r0['world_sizes']}, resizes "
          f"{r0['resizes']}")
    check(r1["world_sizes"] == [2] * RESIZE_AT
          and [tuple(x) for x in r1["resizes"]] == [(RESIZE_AT, 2, 1)],
          f"resize: rank 1 world sizes {r1['world_sizes']}, resizes "
          f"{r1['resizes']}")
    # world size 1 over the same global batches, in this process
    hidden = None
    if "--hidden" in extra_args:
        hidden = int(extra_args[list(extra_args).index("--hidden") + 1])
    cfg, S = resize_cfg(torch, tbench, tllama, hidden)
    loader = resize_loader(tio, cfg, S)
    want_ids = []

    def feed():
        for i, b in enumerate(loader):
            if i == RESIZE_STEPS:
                break
            want_ids.append(b["ids"].tolist())
            yield _pair(b)

    ws1 = dist.Plan().run_train_loop(cfg, feed(), seed=0,
                                     device=device or "cuda")
    err = max(abs(a - b) for a, b in zip(r0["losses"], ws1["losses"]))
    check(len(r0["losses"]) == RESIZE_STEPS and err <= DIST_LOSS_ATOL,
          f"resize: rank 0 losses {r0['losses']} vs world size 1 "
          f"{ws1['losses']}")
    check(r0["ids"] == want_ids and r1["ids"] == want_ids[:RESIZE_AT],
          f"resize: trained ids rank 0 {r0['ids']}, rank 1 {r1['ids']}, "
          f"the loader's {want_ids}")
    flat = [i for b in r0["ids"] for i in b]
    check(len(set(flat)) == len(flat), "resize: a sample was replayed")
    rc = r0["restore"]
    check(rc["saved_differ_count"] == 0 and rc["leaves"] > 0,
          f"resize: the checkpoint differs from the state gathered before "
          f"the save in {rc['saved_differ_count']} leaves, e.g. "
          f"{rc['saved_differ']}")
    check(rc["restore"]["bit_equal"],
          f"resize: rank 0's losses after the resize {r0['losses']} are not "
          f"bit-equal to steps from the saved state {rc['restore']}")
    check(not rc["from_init"]["bit_equal"]
          and not rc["zeroed_moments"]["bit_equal"],
          f"resize: a control matched rank 0's losses bit for bit: {rc}")
    (st,) = r0["resize_stats"]
    res = {"losses": r0["losses"], "losses_ws1": ws1["losses"],
           "loss_err": err, "world_sizes": r0["world_sizes"],
           "resizes": r0["resizes"], "rank1_steps": len(r1["losses"]),
           "save_s": st["save_s"], "group_s": st["group_s"],
           "restore_s": st["restore_s"], "saved_bytes": st["saved_bytes"],
           "restore_check": {k: (rc[k] if not isinstance(rc[k], dict)
                                 else {"bit_equal": rc[k]["bit_equal"],
                                       "max_abs_diff": rc[k]["max_abs_diff"]})
                             for k in ("leaves", "saved_differ_count",
                                       "restore", "from_init",
                                       "zeroed_moments")},
           "rank_seconds": [done[r]["seconds"] for r in (0, 1)],
           "launches_rank0": r0["launches"],
           "peak_rank0": r0["peak"], "pod_wall_s": wall,
           "seconds": wall + time.perf_counter() - t_all}
    if device != "cpu":
        bad = [n for n in TRAIN_PATH_KERNELS if not r0["launches"][n]]
        check(not bad, f"resize: kernels {bad} never launched")
    print(f"resize [{card}]: {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------
# the model families' front ends: GPT-2 small, Llama's generate and eager
# class, ERNIE-base pretraining; the perf ledger
# ---------------------------------------------------------------------------

# GPT-2 small (GPTConfig's defaults): batch, sequence, timed train steps
# (after one warm-up), remat steps; generate's batch, prompt, new tokens;
# the uncached greedy's tokens
GPT_TRAIN, GPT_STEPS, GPT_REMAT_STEPS = (8, 1024), 5, 2
GPT_GEN, GPT_GREEDY_CHECK = (8, 32, 64), 8
# llama7b over int8 weights: batch, prompt, new tokens; the int8 matmuls
# of one forward (7 a layer + the head)
LLAMA_GEN = (8, 128, 32)
LLAMA7B_INT8_CALLS = 7 * 32 + 1
# LlamaForCausalLM at bench.py's shape: the forward's batch and sequence
# are FUSED_SHAPE's (where fused_phase holds rows 7-9 to their plain
# versions), then generate's prompt and new tokens
FACADE_GEN = (32, 16)
# ERNIE-base: batch, sequence, masked positions a row (15 %), steps
ERNIE_SHAPE, ERNIE_MASKED, ERNIE_STEPS = (32, 512), 80, 10
# H100 SXM f32 peak (NVIDIA data sheet; no tensor cores: TF32 is off in
# this script)
PEAK_F32_S = 67e12
# bf16 tolerance of the cached prefill's last logits against forward_pure's
GPT_PREFILL_REL_MAX = 2e-2
# small configs of a CPU rehearsal (``models_phase(..., device="cpu")``)
SMALL_GPT = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=2, max_position_embeddings=128)
SMALL_ERNIE = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, type_vocab_size=2)


def gpt_step_flops(cfg, B, S):
    """Model FLOPs of one GPT train step (forward + backward = 3 x the
    forward's 2 per multiply-add): the blocks' weight products (12 H^2 a
    layer: q, k, v, the projection, the 4H MLP) and the tied head over
    B S tokens, and causal attention (q k^T and p v over the S (S + 1) / 2
    visible pairs)."""
    H, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    weights = (12 * L * H * H + H * V) * B * S
    attention = L * 2 * B * (S * (S + 1) // 2) * H
    return 6.0 * (weights + attention)


def llama_decode_reckoning(cfg, B, S_max):
    """Bytes and int8 operations of one decode step of ``generate`` over
    int8 weights: every int8 weight and its f32 row scales read once (7
    matmuls a layer and the head), the dense cache of ``S_max`` positions
    read once a layer (K and V at the activation dtype; the step's
    attention runs over all of it), one token's activations in and out
    neglected; 2 operations a multiply-add over the B rows."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    KV = cfg.num_key_value_heads * cfg.head_dim
    shapes = [(H, H), (H, KV), (H, KV), (H, H), (H, I), (H, I), (I, H)]
    weights = L * sum(k * n for k, n in shapes) + H * cfg.vocab_size
    scales = 4 * (L * sum(n for _, n in shapes) + cfg.vocab_size)
    cache = L * 2 * B * S_max * KV * cfg.dtype.itemsize
    return weights + scales + cache, 2 * B * weights


def _ids(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def gpt_phase(torch, tgpt, fa, card, device="cuda"):
    """GPT-2 small at full width and depth (12 x 768, 12 heads of 64,
    vocab 50304, bf16): ``loss_fn`` + backward + AdamW at B = 8, S = 1024,
    one warm-up and ``GPT_STEPS`` timed steps, then ``GPT_REMAT_STEPS``
    under ``use_remat`` ("dots"); every flash launch counted (12 / 12 a
    step without remat, 24 / 12 with: the forward is recomputed in the
    backward).  Then ``GPTForCausalLM.generate`` (B = 8, a 32-token
    prompt, 64 new tokens, greedy): the cached prefill's last logits
    against ``forward_pure``'s (flash), and its first tokens against an
    uncached greedy."""
    from paddle_tpu_torch.bench import leaves
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    cfg = (tgpt.GPTConfig() if on_card
           else tgpt.GPTConfig(dtype=torch.float32, **SMALL_GPT))
    (B, S), L = (GPT_TRAIN if on_card else (2, 64)), cfg.num_hidden_layers
    params = tgpt.init_params(cfg, 0, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves(params), lr=3e-4, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.1)
    batch = {"input_ids": torch.from_numpy(_ids(cfg.vocab_size, (B, S), 0))
             .to(dev),
             "labels": torch.from_numpy(_ids(cfg.vocab_size, (B, S), 1))
             .to(dev)}

    def step(c):
        opt.zero_grad(set_to_none=True)
        loss = tgpt.loss_fn(c, params, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step(cfg)]
    _reset_peak(torch, dev)
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(GPT_STEPS):
        losses.append(step(cfg))
    _sync(torch, dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / GPT_STEPS
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd": fa.flash_bwd.launches}
    peak = _peak(torch, dev)
    remat = tgpt.GPTConfig(**{**cfg.__dict__, "use_remat": True})
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(GPT_REMAT_STEPS):
        losses.append(step(remat))
    _sync(torch, dev)
    remat_ms = 1e3 * (time.perf_counter() - t0) / GPT_REMAT_STEPS
    launches_remat = {"flash_fwd": fa.flash_fwd.launches,
                      "flash_bwd": fa.flash_bwd.launches}
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"gpt: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"gpt: step-0 loss {losses[0]} not within 0.5 of ln V")
    if on_card:
        want = {"flash_fwd": L * GPT_STEPS, "flash_bwd": L * GPT_STEPS}
        check(launches == want, f"gpt: flash launches {launches} over "
              f"{GPT_STEPS} steps, expected {want}")
        want = {"flash_fwd": 2 * L * GPT_REMAT_STEPS,
                "flash_bwd": L * GPT_REMAT_STEPS}
        check(launches_remat == want, f"gpt remat: flash launches "
              f"{launches_remat} over {GPT_REMAT_STEPS} steps, expected "
              f"{want}")
    del params, opt, batch

    # generation through the eager class (its own weights, seed 0, on
    # the current place)
    import paddle_tpu_torch as paddle
    Bg, P, new = GPT_GEN if on_card else (2, 8, 6)
    paddle.set_device(dev)
    model = tgpt.GPTForCausalLM(cfg)
    tree = model._tree()
    prompt = torch.from_numpy(_ids(cfg.vocab_size, (Bg, P), 2)).to(dev)
    with torch.no_grad():
        cache = tgpt.decoding.init_kv_cache(L, Bg, P, cfg.num_attention_heads,
                                            cfg.head_dim, cfg.dtype, dev)
        cached, _ = tgpt.forward_with_cache(cfg, tree, prompt, cache, 0)
        full = tgpt.forward_pure(cfg, tree, prompt)
    prefill_rel = rms_rel(cached[:, -1], full[:, -1], False)
    check(prefill_rel <= GPT_PREFILL_REL_MAX, f"gpt: cached prefill's last "
          f"logits {prefill_rel} from forward_pure's (limit "
          f"{GPT_PREFILL_REL_MAX})")
    _sync(torch, dev)
    t0 = time.perf_counter()
    model.generate(prompt, 1)
    _sync(torch, dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    toks = model.generate(prompt, new)._t
    _sync(torch, dev)
    gen_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (Bg, new) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"gpt: generate gave {tuple(toks.shape)} / ids out of range")
    seq, n_check = prompt, min(GPT_GREEDY_CHECK, new)
    with torch.no_grad():
        for _ in range(n_check):
            nxt = tgpt.forward_pure(cfg, tree, seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    match = (seq[:, P:] == toks[:, :n_check]).float().mean().item()
    flops = gpt_step_flops(cfg, B, S)
    out = dict(step_ms=step_ms, tokens_per_sec=B * S / (step_ms / 1e3),
               model_flops_per_step=flops,
               step_bound_ms=bound_ms(0, flops, "bf16")[0],
               remat_step_ms=remat_ms, peak_bytes=peak, losses=losses,
               launches_per_step={n: c / GPT_STEPS
                                  for n, c in launches.items()},
               launches_per_step_remat={n: c / GPT_REMAT_STEPS
                                        for n, c in launches_remat.items()},
               gen_tokens_per_sec=Bg * new / gen_s,
               gen_prefill_ms=prefill_ms,
               gen_decode_step_ms=1e3 * (gen_s - prefill_ms / 1e3)
               / (new - 1),
               prefill_logits_rel=prefill_rel,
               greedy_match_first8=match,
               shape=dict(B=B, S=S, gen=(Bg, P, new)))
    print(f"gpt2-small [{card}]: {json.dumps(out)}")
    return out


def llama_generate_phase(torch, tllama, i8, params, serve, card,
                         cfg=None):
    """``llama.generate`` at llama7b width and depth over ``serve_phase``'s
    int8 weights (``quantize_params``): B = 8, a 128-token prompt, 32 new
    tokens, greedy; every int8 matmul launch counted (225 a forward:
    the prefill, then each decode step), the prefill alone timed apart
    from the whole run.  The prefill's M (B x prompt) and the decode's
    (B) are among ``INT8_ROWS``, where ``int8_phase`` holds the kernel to
    its plain version."""
    cfg = cfg or tllama.preset("llama7b")
    dev = params["embed"].device
    check(isinstance(params["layers"]["wq"], dict)
          and isinstance(params["lm_head"], dict),
          "llama generate: the weights are not int8 leaves")
    B, P, new = LLAMA_GEN
    check(B in INT8_ROWS and B * P in INT8_ROWS, f"llama generate: M = {B} "
          f"and {B * P} are not both among INT8_ROWS {INT8_ROWS}")
    calls = 7 * cfg.num_hidden_layers + 1
    prompt = torch.from_numpy(_ids(cfg.vocab_size, (B, P), 3)).to(dev)
    tllama.generate(cfg, params, prompt, 2)            # first-call costs
    _sync(torch, dev)
    i8.int8_matmul.launches = 0
    t0 = time.perf_counter()
    tllama.generate(cfg, params, prompt, 1)
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = i8.int8_matmul.launches
    i8.int8_matmul.launches = 0
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    toks = tllama.generate(cfg, params, prompt, new)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = i8.int8_matmul.launches
    if dev.type == "cuda":
        check(prefill_launches == calls, f"llama generate: the prefill "
              f"launched int8_matmul {prefill_launches} times, not {calls}")
        check(launches == calls * new, f"llama generate: {launches} "
              f"int8_matmul launches over the prefill + {new - 1} decode "
              f"steps, not {calls} each")
    check(tuple(toks.shape) == (B, new) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "llama generate: bad tokens")
    decode_ms = 1e3 * (wall - prefill_s) / (new - 1)
    nbytes, ops = llama_decode_reckoning(cfg, B, P + new)
    out = dict(tokens_per_sec=B * new / wall, decode_step_ms=decode_ms,
               decode_bytes=nbytes, decode_bound_ms=bound_ms(nbytes, ops,
                                                             "int8")[0],
               prefill_ms=1e3 * prefill_s, launches=launches,
               launches_per_decode_step=calls, peak_bytes=_peak(torch, dev),
               serve_decode_step_ms={n: serve[n]["decode_step_ms"]
                                     for n in ("bf16", "int8")
                                     if n in serve},
               shape=dict(B=B, prompt=P, new=new))
    print(f"llama generate [{card}]: {json.dumps(out)}")
    return out


def facade_phase(torch, tbench, tllama, fb, card, device="cuda", cfg=None):
    """``LlamaForCausalLM`` at bench.py's shape (its parameters drawn from
    seed 0 on the card) and ``FUSED_SHAPE``'s batch, where ``fused_phase``
    holds rows 7-9 to their plain versions: ``forward`` with labels
    launches rows 7-9 once a layer each, its logits are
    ``forward_pure``'s on the same weights and batch bit for bit, its loss
    ``loss_fn``'s within 1e-6 relative; then ``generate`` 16 tokens."""
    dev = _device(torch, device)
    cfg = cfg or tllama.LlamaConfig(**tbench.MODEL)
    B, S, H, D, I = FUSED_SHAPE
    L = cfg.num_hidden_layers
    if dev.type == "cuda":
        check((S, H, D, I) == (tbench.SEQ, cfg.hidden_size, cfg.head_dim,
                               cfg.intermediate_size),
              f"facade: the model's shape is not FUSED_SHAPE {FUSED_SHAPE}")
    else:                    # a CPU rehearsal's tiny cfg
        S = min(S, cfg.max_position_embeddings)
    import paddle_tpu_torch as paddle
    paddle.set_device(dev)
    model = tllama.LlamaForCausalLM(cfg)
    batch = tbench.make_batch(cfg, B, S, dev)
    rows = ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd")
    with torch.no_grad():
        for n in rows:
            getattr(fb, n).launches = 0
        t0 = time.perf_counter()
        loss, logits = model(batch["input_ids"], labels=batch["labels"])
        _sync(torch, dev)
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        launches = {n: getattr(fb, n).launches for n in rows}
        tree = model._tree()
        ref, _ = tllama.forward_pure(cfg, tree, batch["input_ids"])
        same = torch.equal(logits._t, ref)
        del ref
        _, ce = tllama.loss_fn(cfg, tree, batch)
    rel = abs(loss.item() - ce.item()) / abs(ce.item())
    if dev.type == "cuda":
        check(launches == {n: L for n in rows}, f"facade: launches "
              f"{launches}, expected {L} each")
    check(same, "facade: LlamaForCausalLM logits differ from forward_pure's")
    check(rel <= 1e-6, f"facade: loss {loss.item()} vs loss_fn's {ce.item()}"
          f" (rel {rel})")
    keys = sorted(model.state_dict())
    del logits
    P, new = FACADE_GEN
    t0 = time.perf_counter()
    toks = model.generate(batch["input_ids"][:, :P], new)._t
    _sync(torch, dev)
    gen_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (B, new), f"facade: generate gave "
          f"{tuple(toks.shape)}")
    out = dict(forward_ms=fwd_ms, loss=loss.item(), loss_fn_ce=ce.item(),
               loss_rel=rel, logits_bit_equal=same, launches=launches,
               generate_tokens_per_sec=B * new / gen_s,
               state_dict_keys=len(keys), shape=dict(B=B, S=S, gen=(P, new)))
    print(f"LlamaForCausalLM [{card}]: {json.dumps(out)}")
    del model
    return out


def ernie_batch(torch, cfg, B, S, n_masked, dev, seed=4):
    """A pretraining batch in the reference's masked-positions format:
    ``n_masked`` positions a row (no repeats, never position 0) replaced
    by [MASK] (id 3), their ids the labels, two segments, random NSP
    labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (B, S))
    pos = np.stack([np.sort(rng.choice(np.arange(1, S), n_masked,
                                       replace=False)) for _ in range(B)])
    labels = np.take_along_axis(ids, pos, axis=1)
    np.put_along_axis(ids, pos, 3, axis=1)
    tt = np.zeros((B, S), np.int64)
    tt[:, S // 2:] = 1
    host = {"input_ids": ids, "token_type_ids": tt,
            "attention_mask": np.ones((B, S), np.int64),
            "masked_positions": pos, "masked_labels": labels,
            "nsp_labels": rng.integers(0, 2, (B,))}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host.items()}


def ernie_flops(cfg, B, S, n_masked):
    """Model FLOPs of one pretrain step (forward + backward = 3 x the
    forward's 2 per multiply-add): the encoder's weight products over
    B S tokens, its attention (q k^T and p v, every pair), the MLM
    head's transform and tied decoder over the B n_masked gathered rows,
    the pooler and NSP head."""
    H, I, L, V = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    encoder = L * (4 * H * H + 2 * H * I) * B * S
    attention = L * 2 * B * S * S * H
    mlm = (H * H + H * V) * B * n_masked
    heads = (H * H + 2 * H) * B
    return 6.0 * (encoder + attention + mlm + heads)


def ernie_phase(torch, ternie, dist, card, device="cuda"):
    """ERNIE-base pretraining at full width and depth (12 x 768, vocab
    18000, S = 512, f32) at world size 1: ``ERNIE_STEPS`` steps of
    ``build_pretrain_step`` at B = 32 with 80 masked positions a row, on
    one fixed batch; the loss must fall.  Step ms over the steps after
    the first, peak memory, MFU against the f32 peak (TF32 is off)."""
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    cfg = (ternie.ErnieConfig() if on_card
           else ternie.ErnieConfig(**SMALL_ERNIE))
    (B, S), n_masked = ((ERNIE_SHAPE, ERNIE_MASKED) if on_card
                        else ((4, 32), 5))
    step, init = ternie.build_pretrain_step(cfg, dist.HybridTopology(),
                                            device=dev)
    params, opt = init(0)
    batch = ernie_batch(torch, cfg, B, S, n_masked, dev)
    _reset_peak(torch, dev)
    losses, times = [], []
    for _ in range(ERNIE_STEPS):
        t0 = time.perf_counter()
        _, _, m = step(params, opt, batch)
        losses.append(m["loss"].item())      # a sync: the step's end
        times.append(time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses), f"ernie: losses {losses}")
    check(losses[-1] < losses[0], f"ernie: the loss did not fall: {losses}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "ernie: TF32 is on; the MFU's peak is f32's")
    step_ms = 1e3 * float(np.mean(times[1:]))
    flops = ernie_flops(cfg, B, S, n_masked)
    out = dict(step_ms=step_ms, first_step_ms=1e3 * times[0],
               losses=losses, peak_bytes=_peak(torch, dev),
               model_flops_per_step=flops,
               step_bound_ms=1e3 * flops / PEAK_F32_S,
               mfu_percent=(100.0 * flops / (step_ms / 1e3) / PEAK_F32_S
                            if on_card else None),
               peak_flops=PEAK_F32_S, tf32=False,
               tokens_per_sec=B * S / (step_ms / 1e3),
               shape=dict(B=B, S=S, masked=n_masked, dtype=str(cfg.dtype)))
    print(f"ernie-base [{card}]: {json.dumps(out)}")
    del params, opt, batch
    return out


def models_phase(torch, tllama, i8, fa, fb, dist, params, serve, card,
                 tbench):
    """The model families' front ends on the card: GPT-2 small trained and
    generating, llama7b's ``generate`` over the serve weights,
    ``LlamaForCausalLM`` at bench.py's shape, ERNIE-base pretraining."""
    from paddle_tpu_torch.models import ernie as ternie
    from paddle_tpu_torch.models import gpt as tgpt
    t0 = time.perf_counter()
    out = {"gpt": gpt_phase(torch, tgpt, fa, card)}
    gc_cuda(torch)
    out["llama_generate"] = llama_generate_phase(torch, tllama, i8, params,
                                                 serve, card)
    gc_cuda(torch)
    out["facade"] = facade_phase(torch, tbench, tllama, fb, card)
    gc_cuda(torch)
    out["ernie"] = ernie_phase(torch, ternie, dist, card)
    gc_cuda(torch)
    out["seconds"] = time.perf_counter() - t0
    print(f"models phase [{card}]: {out['seconds']:.1f} s")
    return out


# the eager phase: bench.py's Llama trained the Paddle way, 6 steps at
# a warmed-up lr ~1e-3 on one batch; GPT-2 small 3 steps; generate's
# new tokens
EAGER_STEPS, EAGER_LR, EAGER_GPT_STEPS, EAGER_GEN = 6, 1e-3, 3, 16


def eager_ops_check(torch, device="cuda"):
    """Every case of the op sweep (``testing/op_cases.py``, the cases the
    CPU tests hold against JAX) run with CUDA tensors and with CPU
    tensors through the port's ``OP_LIBRARY``: outputs and gradients
    compared at each case's tolerance (f32 1e-5, reductions / linalg /
    gradients 1e-4, bf16 2e-2), every output on the card; then every
    random op's law and reproducibility on the card.  Prints ``eager_ops
    <passed>/<total>``; any mismatch fails the run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.registry import OP_LIBRARY
    from paddle_tpu_torch.testing import op_cases
    dev = _device(torch, device)
    t0 = time.perf_counter()
    bad, total = [], 0
    for c in op_cases.PARITY:
        total += 1
        try:
            paddle.set_device("cpu")
            want = op_cases.run(c, paddle, OP_LIBRARY)
            paddle.set_device(dev)
            outs = []
            got = op_cases.run(c, paddle, OP_LIBRARY, tensors=outs)
            where = {o._t.device.type for o in outs}
            check(where == {dev.type}, f"{c.id}: outputs on {where}")
            op_cases.compare(c, got, want, where=f" ({dev.type} vs cpu)")
        except Exception as exc:     # noqa: BLE001 - each case reported
            bad.append(f"{c.id}: {type(exc).__name__}: "
                       f"{str(exc)[:300]}")
    paddle.set_device(dev)
    for law in op_cases.LAWS:
        total += 1
        try:
            law.check(paddle)
        except Exception as exc:     # noqa: BLE001
            bad.append(f"law {law.id}: {type(exc).__name__}: "
                       f"{str(exc)[:300]}")
    passed = total - len(bad)
    print(f"eager_ops {passed}/{total}")
    for b in bad:
        print(f"eager_ops mismatch: {b}")
    check(not bad, f"eager ops: {len(bad)} of {total} cases failed on "
          f"{dev.type}")
    return dict(passed=passed, total=total, parity=len(op_cases.PARITY),
                laws=len(op_cases.LAWS),
                seconds=time.perf_counter() - t0)


def plain_cross_entropy(torch, logits, labels):
    """The reference's mean cross-entropy over [N, V] logits written out
    (``nn/functional/loss.py``: log_softmax in the logits' dtype, ignored
    labels masked, the mean over ``max(Σ valid, 1)``)."""
    logp = torch.log_softmax(logits, 1)
    lab = labels.long()
    valid = lab != -100
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    per = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
    per = torch.where(valid, per, torch.zeros((), dtype=per.dtype,
                                              device=per.device))
    return torch.sum(per) / torch.clamp(torch.sum(valid.to(per.dtype)),
                                        min=1.0)


def plain_adamw_update(torch, params, grads, lr, clip, beta1=0.9,
                       beta2=0.999, eps=1e-8, wd=0.01, t=1):
    """The reference's ClipGradByGlobalNorm then AdamW step ``t`` from
    zero moments (``optimizer.py:348-384``), written out: float32 grads
    and moments, ``p - lr m̂ / (√v̂ + ε) - lr wd p``, cast back."""
    out = []
    with torch.no_grad():
        sq = [torch.sum(g.float() ** 2) for g in grads]
        norm = torch.sqrt(sum(sq))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        for p, g in zip(params, grads):
            g = ((g.float() * scale).to(g.dtype)).to(torch.float32)
            m = torch.zeros_like(p, dtype=torch.float32)
            v = torch.zeros_like(p, dtype=torch.float32)
            m = beta1 * m + (1 - beta1) * g
            v = beta2 * v + (1 - beta2) * g * g
            m_hat = m / (1 - beta1 ** t)
            v_hat = v / (1 - beta2 ** t)
            p32 = p.to(torch.float32)
            new = p32 - lr * m_hat / (torch.sqrt(v_hat) + eps)
            new = new - lr * wd * p.to(torch.float32)
            out.append(new.to(p.dtype))
    return out


def eager_phase(torch, tbench, tllama, fa, fb, card, functional,
                device="cuda", cfg=None, gpt_cfg=None):
    """The eager core on the card (``paddle_tpu_torch`` as ``paddle``).

    The op sweep (``eager_ops_check``).  Then ``LlamaForCausalLM`` at
    bench.py's shape (B 4, S 2048, the functional step's "dots" remat
    and fused blocks), built after ``set_device("gpu")`` and ``seed(0)``,
    trained ``EAGER_STEPS`` steps on one batch with ``AdamW(LinearWarmup,
    ClipGradByGlobalNorm(1.0))``: step 1's loss and every ``.grad``
    bit-equal to ``torch.autograd.grad`` of ``forward_pure`` +
    ``plain_cross_entropy`` on raw copies of the parameters; step 1's
    update bit-equal to ``plain_adamw_update``; the losses finite and
    the last below the first; the launches a step of rows 7-10 and the
    flash wrappers equal to ``functional``'s (``train_phase``'s fused
    result).  The eager step and ``optimizer.step()`` in ms (steps 2 on)
    beside the functional step, the peak over what the phase started
    with.  Then GPT-2 small, ``EAGER_GPT_STEPS`` steps (flash at D 64,
    one call a layer each way a step) and ``generate``: a ``Tensor``
    equal to the functional ``generate``'s tokens."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt as tgpt
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    out = {"ops": eager_ops_check(torch, dev)}
    kernels = dict(tbench.KERNELS)

    # -- Llama at bench.py's shape
    cfg = cfg or tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
    B, S = (4, tbench.SEQ) if on_card else (2, 32)
    if on_card:
        gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    _reset_peak(torch, dev)
    paddle.set_device(dev)
    paddle.seed(0)
    net = tllama.LlamaForCausalLM(cfg)
    params = net.parameters()
    check(all(p._t.device.type == dev.type and p.is_leaf for p in params),
          "eager: the parameters are not leaves on the card")
    sched = paddle.optimizer.lr.LinearWarmup(EAGER_LR, 2, EAGER_LR / 10,
                                             EAGER_LR)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=params,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    batch = tbench.make_batch(cfg, B, S, dev)
    ids = paddle.to_tensor(batch["input_ids"])
    labels = paddle.to_tensor(batch["labels"])
    V = cfg.vocab_size

    # step 1's reference: the raw composition on copies of the params
    raw = [p._t.detach().clone().requires_grad_(p._t.requires_grad)
           for p in params]
    tree = tllama._unflatten_params(dict(zip(net._names, raw)))
    logits, _ = tllama.forward_pure(cfg, tree, batch["input_ids"])
    ref_loss = plain_cross_entropy(torch, logits.reshape(-1, V),
                                   batch["labels"].reshape(-1))
    diff = [r for r in raw if r.requires_grad]
    ref_grads = torch.autograd.grad(ref_loss, diff)
    ref_loss = ref_loss.detach()
    del logits, tree, raw, diff
    if on_card:
        gc_cuda(torch)

    for w in kernels.values():
        w.launches = 0
    losses, step_ms, opt_ms = [], [], []
    same_grads = same_update = None
    for k in range(EAGER_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss, _ = net(ids, labels=labels)
        loss.backward()
        if k == 0:
            same_loss = torch.equal(loss._t.detach(), ref_loss)
            trainable = [p for p in params if not p.stop_gradient]
            same_grads = [torch.equal(p.grad._t, g)
                          for p, g in zip(trainable, ref_grads)]
            del ref_grads
            want = plain_adamw_update(torch, [p._t for p in trainable],
                                      [p.grad._t for p in trainable],
                                      sched(), 1.0)
        _sync(torch, dev)
        t1 = time.perf_counter()
        opt.step()
        _sync(torch, dev)
        t2 = time.perf_counter()
        if k == 0:
            same_update = [torch.equal(p._t, w)
                           for p, w in zip(trainable, want)]
            del want
            # the training steps' own peak, without step 1's checks
            peak_checks = _peak(torch, dev) - base if on_card else None
            _reset_peak(torch, dev)
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
        if k:                        # step 1 carries the checks
            step_ms.append(1e3 * (time.perf_counter() - t0))
            opt_ms.append(1e3 * (t2 - t1))
        del loss
    launches = {n: w.launches for n, w in kernels.items()}
    peak = _peak(torch, dev) - base if on_card else None
    check(same_loss, "eager: step 1's loss differs from the raw "
          "composition's")
    check(all(same_grads), f"eager: {same_grads.count(False)} of "
          f"{len(same_grads)} grads differ from torch.autograd.grad's")
    check(all(same_update), f"eager: {same_update.count(False)} of "
          f"{len(same_update)} parameters differ from the reference's AdamW "
          f"update")
    check(all(math.isfinite(x) for x in losses), f"eager: losses {losses}")
    check(losses[-1] < losses[0], f"eager: the loss did not fall {losses}")
    per_step = {n: c / EAGER_STEPS for n, c in launches.items()}
    if on_card:
        fn = functional["launches_per_step"]
        check(per_step == fn, f"eager: launches a step {per_step} vs the "
              f"functional step's {fn}")
        for n in ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
                  "fused_mlp_bwd_dx", "flash_bwd"):
            check(launches[n] > 0, f"eager: {n} never launched")
    eager_ms = float(np.mean(step_ms))
    out["llama"] = dict(
        losses=losses, step1_loss_bit_equal=same_loss,
        step1_grads_bit_equal=len(same_grads),
        step1_update_bit_equal=len(same_update), launches=launches,
        launches_per_step=per_step, step_ms=eager_ms,
        step_ms_each=step_ms, optimizer_step_ms=float(np.mean(opt_ms)),
        optimizer_step_ms_each=opt_ms,
        functional_step_ms=functional["step_ms"],
        step_over_functional=(eager_ms / functional["step_ms"]
                              if functional.get("step_ms") else None),
        peak_over_base=peak, peak_over_base_with_checks=peak_checks,
        functional_peak=functional.get("max_memory_allocated"),
        n_params=sum(p.size for p in params),
        shape=dict(B=B, S=S, remat=cfg.remat_policy))
    del net, opt, params, trainable, ids, labels, batch
    if on_card:
        gc_cuda(torch)

    # -- GPT-2 small eagerly
    gcfg = gpt_cfg or (tgpt.GPTConfig() if on_card
                       else tgpt.GPTConfig(dtype=torch.float32, **SMALL_GPT))
    (Bg, Sg), L = (GPT_TRAIN if on_card else (2, 64)), \
        gcfg.num_hidden_layers
    paddle.seed(0)
    gnet = tgpt.GPTForCausalLM(gcfg)
    gsched = paddle.optimizer.lr.LinearWarmup(EAGER_LR, 2, EAGER_LR / 10,
                                              EAGER_LR)
    gopt = paddle.optimizer.AdamW(
        learning_rate=gsched, parameters=gnet.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    gids = paddle.to_tensor(_ids(gcfg.vocab_size, (Bg, Sg), 0))
    glabels = paddle.to_tensor(_ids(gcfg.vocab_size, (Bg, Sg), 1))
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    glosses, gms = [], []
    for _ in range(EAGER_GPT_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss, _ = gnet(gids, labels=glabels)
        loss.backward()
        gopt.step()
        gopt.clear_grad()
        gsched.step()
        glosses.append(loss.item())
        gms.append(1e3 * (time.perf_counter() - t0))
    gpt_ms = float(np.mean(gms[1:]))     # step 1 makes the moments
    glaunch = {"flash_fwd": fa.flash_fwd.launches,
               "flash_bwd": fa.flash_bwd.launches}
    check(all(math.isfinite(x) for x in glosses), f"eager gpt: {glosses}")
    if on_card:
        want = {"flash_fwd": L * EAGER_GPT_STEPS,
                "flash_bwd": L * EAGER_GPT_STEPS}
        check(glaunch == want, f"eager gpt: flash launches {glaunch}, "
              f"expected {want}")
    prompt = paddle.to_tensor(_ids(gcfg.vocab_size, (Bg, 32), 2))
    toks = gnet.generate(prompt, EAGER_GEN)
    check(isinstance(toks, paddle.Tensor), "eager gpt: generate returned "
          f"{type(toks).__name__}, not a Tensor")
    ref = tgpt.generate(gcfg, gnet._tree(), prompt._t, EAGER_GEN)
    check(torch.equal(toks._t, ref), "eager gpt: generate's tokens differ "
          "from the functional generate's")
    out["gpt"] = dict(losses=glosses, step_ms=gpt_ms, step_ms_each=gms,
                      launches=glaunch,
                      generate_equal=True, shape=dict(B=Bg, S=Sg,
                                                      gen=EAGER_GEN))
    del gnet, gopt
    if on_card:
        gc_cuda(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"eager [{card}]: {json.dumps(out)}")
    print(f"eager [{card}]: Llama step {eager_ms:.2f} ms (optimizer.step() "
          f"{out['llama']['optimizer_step_ms']:.2f} ms) vs the functional "
          f"step {functional['step_ms']:.2f} ms; peak over base {peak}; "
          f"losses {[round(x, 4) for x in losses]}")
    return out


# the vision stack: which of the sweep's ops it brought (their cases run
# in eager_ops_check with the rest), LeNet's example and ResNet-50 fit
VISION_OPS = {
    "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "lp_pool1d", "lp_pool2d",
    "max_pool1d", "max_pool2d", "max_pool3d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d",
    "affine_grid", "grid_sample", "temporal_shift",
    "class_center_sample", "edit_distance", "gather_tree",
    "margin_cross_entropy", "sequence_mask",
    "segment_max", "segment_mean", "segment_min", "segment_sum",
    "box_iou", "nms", "roi_align",
}
PEAK_F32_OPS_S = 67e12      # the card's float32 rate outside the tensor cores
# a vision step's device rows by class (first match; cuDNN's convolution
# kernels before the GEMM pattern, which their names also match)
VISION_CLASSES = (
    ("convolution (cuDNN)", r"(?i)conv|cudnn|xmma|fprop|dgrad|wgrad"
                            r"|winograd|fft|implicit|scudnn|cutlass"),
    ("batch norm", r"(?i)batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("cuBLAS GEMMs", r"nvjet|gemm|cublas|splitKreduce"),
    ("pooling", r"(?i)pool"),
    ("memcpy / memset", r"(?i)memcpy|memset"),
    ("elementwise / reduction", r"at::native|elementwise|reduce|CatArray"
                                r"|index|softmax|SoftMax"),
)


def _conv_linear_macs(paddle, net, x):
    """Multiply-adds of one forward of ``net`` on ``x``, from the output
    shapes of its Conv2D and Linear layers (hooks on a no-grad run):
    (convolutions', linear layers')."""
    nn = paddle.nn
    total = [0, 0]

    def hook(layer, inputs, out):
        if isinstance(layer, nn.Conv2D):
            k = int(np.prod(layer._kernel_size))
            total[0] += out.size * (layer._in_channels // layer._groups) * k
        else:
            total[1] += out.size * layer._in_features
    handles = [m.register_forward_post_hook(hook)
               for m in net.sublayers() if isinstance(m, (nn.Conv2D,
                                                          nn.Linear))]
    with paddle.no_grad():
        net.eval()
        net(x)
    for h in handles:
        h.remove()
    return tuple(total)


def _profile_step(torch, step, head, classes, class_flops):
    """One ``step()`` (after a warm one) under torch.profiler: its wall,
    the device's busy share, the kernels launched and the device time by
    class."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    print_profile(prof, wall_us, head, 8)
    launches = sum(e.count for e in device_rows(prof))
    busy = busy_union_us(prof)
    print(f"{head}: {launches} kernels and copies, {wall_us / launches:.1f} "
          f"us of wall a launch")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us, launches=launches,
                classes=profile_classes(prof, head, class_flops, {},
                                        classes))


class _StepClock:
    """A hapi callback timing each train batch on the host clock, the
    device synchronised at both ends, and the gap before it (the
    loader's next batch)."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.step_ms, self.wait_ms = [], []
        self._end = None

    def set_model(self, model):
        pass

    def set_params(self, params):
        pass

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = self._sync()
        if self._end is not None:
            self.wait_ms.append((self._t0 - self._end) * 1e3)

    def on_train_batch_end(self, step, logs=None):
        self._end = self._sync()
        self.step_ms.append((self._end - self._t0) * 1e3)


def vision_phase(torch, card, device="cuda", image=224, batch=64, iters=8):
    """The vision stack on the card.

    - The port's LeNet example (``paddle_tpu_torch.examples.train_lenet``)
      run through ``main``: 30 steps uninterrupted, then a run cut after
      step 23 (its newest commit is step 20) and resumed: the resumed
      run must report step 20 and give the uninterrupted run's losses
      from step 21 on bit for bit.  cuDNN runs deterministic algorithms
      for it (``cudnn.deterministic``; its backward ones may otherwise
      add with atomics), and the loss must fall.
    - ResNet-50 at its published width (1000 classes, 3 x 224 x 224,
      float32, TF32 off as in the whole run) trained by ``Model.fit``
      with Momentum(0.1, 0.9), CrossEntropyLoss and Accuracy on
      ``SyntheticImages(10 * 64, ...)`` at batch 64 for 8 iterations;
      steps 3-8 are timed on the host clock around synchronised steps.
      The loss must be finite and the batch norms' running statistics
      must have moved.  Reported: step ms, images/s, the peak memory
      and the share of the float32 peak (2 x the multiply-adds of the
      convolutions and the classifier, x 3 for forward and backward).

    ``device="cpu"`` (with a small ``image``, ``batch`` and ``iters``)
    is the CPU rehearsal."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.examples import train_lenet
    from paddle_tpu_torch.testing import op_cases
    from paddle_tpu_torch.vision.datasets import SyntheticImages
    dev = _device(torch, device)
    place = "gpu" if dev.type == "cuda" else "cpu"
    out = {"sweep_cases": sum(c.name in VISION_OPS
                              for c in op_cases.PARITY)}

    # LeNet: uninterrupted, cut after step 23, resumed from step 20
    root = tempfile.mkdtemp(prefix="lenet_smoke_")
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        full = train_lenet.main(root=os.path.join(root, "full"),
                                device=place, verbose=False)
        t_full = time.perf_counter() - t0
        cut = os.path.join(root, "cut")
        first = train_lenet.main(root=cut, device=place, stop_after=23,
                                 verbose=False)
        resumed = train_lenet.main(root=cut, device=place, verbose=False)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
        shutil.rmtree(root, ignore_errors=True)
    ls = full["losses"]
    check(sorted(ls) == list(range(1, 31)), "lenet: not 30 steps")
    check(np.mean([ls[s] for s in range(26, 31)])
          < np.mean([ls[s] for s in range(1, 6)]), "lenet: the loss did "
          "not fall")
    check(resumed["resumed_from"] == 20,
          f"lenet: resumed from {resumed['resumed_from']}, not 20")
    check(all(first["losses"][s] == ls[s] for s in range(1, 24)),
          "lenet: the cut run's losses differ from the full run's")
    diff = [s for s in range(21, 31) if resumed["losses"][s] != ls[s]]
    check(not diff, f"lenet: resumed losses differ at steps {diff}")
    sms = full["step_ms"]
    out["lenet"] = dict(
        steps=30, loss_first=ls[1], loss_last=ls[30], seconds=t_full,
        step_ms_p50=float(np.median(sms[1:])), step_ms_first=sms[0],
        data_wait_p50_ms=full["data_wait_p50_ms"],
        resumed_from=resumed["resumed_from"], resume_bit_identical=True,
        cudnn_deterministic=True)
    print(f"vision lenet [{card}]: 30 steps in {t_full:.2f} s, step p50 "
          f"{out['lenet']['step_ms_p50']:.3f} ms (first "
          f"{sms[0]:.1f} ms), dataloader_next p50 "
          f"{full['data_wait_p50_ms']:.3f} ms, loss {ls[1]:.4f} -> "
          f"{ls[30]:.4f}; resumed from committed step 20, steps 21-30 "
          f"bit-identical")

    # ResNet-50 through Model.fit
    paddle.set_device(place)
    paddle.seed(0)
    net = paddle.vision.models.resnet50()
    conv_macs, fc_macs = _conv_linear_macs(paddle, net, paddle.to_tensor(
        np.zeros((1, 3, image, image), np.float32)))
    macs = conv_macs + fc_macs
    t0 = time.perf_counter()
    data = SyntheticImages(10 * batch, (3, image, image), 1000)
    t_data = time.perf_counter() - t0
    bn0 = net.bn1._mean.numpy().copy()
    model = paddle.Model(net).prepare(
        paddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters()),
        paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    clock = _StepClock(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = model.fit(data, batch_size=batch, epochs=1, num_iters=iters,
                     shuffle=False, verbose=0, callbacks=[clock])
    t_fit = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    check(len(clock.step_ms) == iters, f"resnet50: {len(clock.step_ms)} "
          f"steps, not {iters}")
    check(np.isfinite(hist["loss"][0]), f"resnet50: loss {hist['loss']}")
    moved = float(np.abs(net.bn1._mean.numpy() - bn0).max())
    check(moved > 0, "resnet50: the batch norm statistics did not move")
    timed = clock.step_ms[2:]
    step_ms = float(np.mean(timed))
    flop = 2.0 * 3 * macs * batch
    out["resnet50"] = dict(
        batch=batch, image=image, iters=iters, loss=hist["loss"][0],
        step_ms=step_ms, step_ms_steps3_8=timed,
        step_ms_first=clock.step_ms[0],
        data_wait_ms=float(np.mean(clock.wait_ms[1:])) if len(
            clock.wait_ms) > 1 else None,
        images_per_s=batch / step_ms * 1e3, peak_bytes=int(peak),
        macs_per_image_fwd=int(macs), flop_per_step=flop,
        f32_peak_share=flop / (step_ms * 1e-3) / PEAK_F32_OPS_S,
        bn_mean_moved=moved, fit_s=t_fit, data_s=t_data,
        precision="float32, cudnn and matmul TF32 off")
    r = out["resnet50"]
    print(f"vision resnet50 [{card}]: B {batch} x 3 x {image} x {image} "
          f"f32, step {step_ms:.2f} ms (steps 3-{iters}; first "
          f"{r['step_ms_first']:.1f} ms), {r['images_per_s']:.1f} "
          f"images/s, peak {peak / 1e9:.2f} GB, {flop / 1e9:.1f} GFLOP a "
          f"step = {100 * r['f32_peak_share']:.1f} % of the f32 peak, "
          f"loss {r['loss']:.4f}, data {t_data:.1f} s")
    if dev.type != "cuda":
        return out
    # where the time goes: one more ResNet-50 step on a batch already on
    # the card, and one LeNet step (the example's net, optimizer and
    # batch size), each under torch.profiler
    xb = paddle.to_tensor(data.images[:batch])
    yb = paddle.to_tensor(data.labels[:batch])
    r["profile"] = _profile_step(
        torch, lambda: model.train_batch([xb], [yb]),
        f"profile resnet50 [{card}]: 1 train_batch, B {batch}",
        VISION_CLASSES,
        {"convolution (cuDNN)": 2.0 * 3 * conv_macs * batch})
    paddle.seed(0)
    lenet = paddle.vision.models.LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=lenet.parameters())
    img = paddle.to_tensor(data.images[:1, :1, :28, :28].repeat(64, 0))
    lab = paddle.to_tensor(data.labels[:64].reshape(-1) % 10)

    def lenet_step():
        loss = paddle.nn.CrossEntropyLoss()(lenet(img), lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        float(loss.numpy())
    out["lenet"]["profile"] = _profile_step(
        torch, lenet_step, f"profile lenet [{card}]: 1 step, B 64",
        VISION_CLASSES, {})
    return out


# ---------------------------------------------------------------------------
# mixed precision (amp) and the sequence layers
# ---------------------------------------------------------------------------

AMP_STEPS, AMP_SCALE = 6, 2.0 ** 15
# bytes a parameter under O2 with AdamW and the clip: the bf16 param, its
# f32 grad after unscale_, the f32 master, two f32 moments, the clip's
# f32 copy of the grad
AMP_BYTES_PER_PARAM = 2 + 4 + 4 + 8 + 4


def amp_phase(torch, tbench, tllama, card, functional, eager,
              device="cuda"):
    """bench.py's Llama trained under AMP O2 (``paddle_tpu_torch.amp``).

    ``LlamaForCausalLM`` at bench.py's width and depth ("dots", fused
    blocks "auto") built in float32 after ``set_device("gpu")`` and
    ``seed(0)``, ``amp.decorate(level="O2", dtype="bfloat16")`` with
    ``AdamW(LinearWarmup, ClipGradByGlobalNorm(1.0))``: every parameter a
    bf16 leaf on the card.  ``AMP_STEPS`` steps on one batch of B 4 x
    2048, the forward and loss under ``auto_cast(level="O2")``, then
    ``GradScaler(2**15)``: ``scale(loss).backward()``, ``unscale_``,
    ``step``, ``update``.  Step 1's loss and its unscaled float32 grads
    are bit-equal to the same composition run by hand on raw copies of
    the bf16 params (``forward_pure``, the black list's float32 cast of
    the logits, ``plain_cross_entropy``, times the scale, the grads in
    float32 divided by it); step 1's float32 master of every parameter
    is bit-equal to ``plain_adamw_update`` on the params in float32 and
    each param is its master's cast; the scale never dropped (no
    step skipped); the losses finite and falling; the launches a step
    of rows 7-10 and the flash wrappers equal ``functional``'s (the
    fused train step's).  Reported: step ms, ``unscale_`` ms and
    ``optimizer.step()`` ms (steps 2 on) beside ``eager``'s bf16 step,
    the peak over the phase's start beside the reckoning of
    ``AMP_BYTES_PER_PARAM`` bytes a parameter.  ``device="cpu"`` runs
    ``DIST_SMALL`` at B 2 x 32 (the rehearsal)."""
    import paddle_tpu_torch as paddle
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    kernels = dict(tbench.KERNELS)
    cfg = tllama.LlamaConfig(
        remat_policy="dots", **dict(tbench.MODEL if on_card else DIST_SMALL,
                                    dtype=torch.float32))
    B, S = (4, tbench.SEQ) if on_card else (2, 32)
    if on_card:
        gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    _reset_peak(torch, dev)
    paddle.set_device(dev)
    paddle.seed(0)
    net = tllama.LlamaForCausalLM(cfg)
    check(all(p._t.dtype == torch.float32 for p in net.parameters()),
          "amp: the model was not built in float32")
    sched = paddle.optimizer.lr.LinearWarmup(EAGER_LR, 2, EAGER_LR / 10,
                                             EAGER_LR)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    net, opt = paddle.amp.decorate(models=net, optimizers=opt, level="O2",
                                   dtype="bfloat16")
    params = net.parameters()
    check(all(p._t.dtype == torch.bfloat16 and p.is_leaf
              and not p.stop_gradient and p._t.device.type == dev.type
              for p in params),
          "amp: after decorate a parameter is not a bf16 leaf on the card")
    check(opt._use_master_weights, "amp: decorate did not mark AdamW")
    scaler = paddle.amp.GradScaler(init_loss_scaling=AMP_SCALE)
    batch = tbench.make_batch(cfg, B, S, dev)
    ids = paddle.to_tensor(batch["input_ids"])
    labels = paddle.to_tensor(batch["labels"])
    V = cfg.vocab_size

    # step 1's reference: the O2 composition by hand on raw copies
    raw = [p._t.detach().clone().requires_grad_(True) for p in params]
    tree = tllama._unflatten_params(dict(zip(net._names, raw)))
    logits, _ = tllama.forward_pure(cfg, tree, batch["input_ids"])
    ref_loss = plain_cross_entropy(torch, logits.reshape(-1, V).float(),
                                   batch["labels"].reshape(-1))
    ref_grads = torch.autograd.grad(ref_loss * AMP_SCALE, raw)
    ref_grads = [g.float() * (1.0 / AMP_SCALE) for g in ref_grads]
    ref_loss = ref_loss.detach()
    del logits, tree, raw
    if on_card:
        gc_cuda(torch)

    for w in kernels.values():
        w.launches = 0
    losses, step_ms, unscale_ms, opt_ms = [], [], [], []
    for k in range(AMP_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = net(ids, labels=labels)
        scaler.scale(loss).backward()
        _sync(torch, dev)
        t1 = time.perf_counter()
        scaler.unscale_(opt)
        _sync(torch, dev)
        t2 = time.perf_counter()
        if k == 0:
            check(loss.dtype == torch.float32, f"amp: loss in {loss.dtype}")
            same_loss = torch.equal(loss._t.detach(), ref_loss)
            grads = [p.grad._t for p in params]
            check(all(g.dtype == torch.float32 for g in grads),
                  "amp: a grad is not float32 after unscale_")
            same_grads = [torch.equal(g, r) for g, r in
                          zip(grads, ref_grads)]
            del ref_grads
            want = plain_adamw_update(torch, [p._t.float() for p in params],
                                      grads, sched(), 1.0)
            del grads
        scaler.step(opt)
        _sync(torch, dev)
        t3 = time.perf_counter()
        scaler.update()
        if k == 0:
            masters = opt._accumulators.get("master_weight", {})
            check(len(masters) == len(params) and all(
                masters[id(p)].dtype == torch.float32 for p in params),
                "amp: the optimizer holds no float32 master for every "
                "parameter")
            same_master = [torch.equal(masters[id(p)], w)
                           for p, w in zip(params, want)]
            same_cast = [torch.equal(p._t, masters[id(p)].to(p._t.dtype))
                         for p in params]
            del want, masters
            peak_checks = _peak(torch, dev) - base if on_card else None
            _reset_peak(torch, dev)
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
        if k:
            step_ms.append(1e3 * (time.perf_counter() - t0))
            unscale_ms.append(1e3 * (t2 - t1))
            opt_ms.append(1e3 * (t3 - t2))
        del loss
    launches = {n: w.launches for n, w in kernels.items()}
    peak = _peak(torch, dev) - base if on_card else None
    check(same_loss, "amp: step 1's loss differs from the O2 composition's")
    check(all(same_grads), f"amp: {same_grads.count(False)} of "
          f"{len(same_grads)} unscaled grads differ from the composition's")
    check(all(same_master), f"amp: {same_master.count(False)} of "
          f"{len(same_master)} masters differ from the reference's AdamW")
    check(all(same_cast), f"amp: {same_cast.count(False)} params are not "
          f"their masters' bf16 cast")
    check(scaler.get_init_loss_scaling() == AMP_SCALE,
          f"amp: the scale moved to {scaler.get_init_loss_scaling()} (a "
          f"step was skipped)")
    check(all(math.isfinite(x) for x in losses), f"amp: losses {losses}")
    check(losses[-1] < losses[0], f"amp: the loss did not fall {losses}")
    per_step = {n: c / AMP_STEPS for n, c in launches.items()}
    if on_card:
        fn = functional["launches_per_step"]
        check(per_step == fn, f"amp: launches a step {per_step} vs the "
              f"functional step's {fn}")
    n_params = sum(p.size for p in params)
    amp_ms = float(np.mean(step_ms))
    eager_ms = eager["llama"]["step_ms"] if eager else None
    out = dict(
        losses=losses, step1_loss_bit_equal=same_loss,
        step1_grads_bit_equal=len(same_grads),
        step1_masters_bit_equal=len(same_master), launches=launches,
        launches_per_step=per_step, step_ms=amp_ms, step_ms_each=step_ms,
        unscale_ms=float(np.mean(unscale_ms)),
        optimizer_step_ms=float(np.mean(opt_ms)),
        optimizer_step_ms_each=opt_ms,
        eager_bf16_step_ms=eager_ms,
        eager_bf16_optimizer_step_ms=(eager["llama"]["optimizer_step_ms"]
                                      if eager else None),
        peak_over_base=peak, peak_over_base_with_checks=peak_checks,
        eager_bf16_peak_over_base=(eager["llama"]["peak_over_base"]
                                   if eager else None),
        n_params=n_params,
        reckoned_state_bytes=n_params * AMP_BYTES_PER_PARAM,
        reckoned_per_param=AMP_BYTES_PER_PARAM,
        scale=scaler.get_init_loss_scaling(),
        shape=dict(B=B, S=S, remat=cfg.remat_policy))
    del net, opt, params, ids, labels, batch, scaler
    if on_card:
        gc_cuda(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"amp [{card}]: {json.dumps(out)}")
    print(f"amp [{card}]: O2 step {amp_ms:.2f} ms (unscale_ "
          f"{out['unscale_ms']:.2f} ms, optimizer.step() "
          f"{out['optimizer_step_ms']:.2f} ms) vs the eager bf16 step "
          f"{eager_ms} ms; peak over base {peak} B vs the reckoned "
          f"{n_params * AMP_BYTES_PER_PARAM} B of state "
          f"({AMP_BYTES_PER_PARAM} B x {n_params} params); losses "
          f"{[round(x, 4) for x in losses]}")
    return out


# the sequence paths at their published widths (Vaswani et al. 2017's
# Transformer-base with a 37,000-token shared vocabulary; ERNIE-base's
# encoder width; an LSTM seq2seq at 512) and the CPU rehearsal's
SEQ_FULL = dict(vocab=37000, d_model=512, nhead=8, layers=6, ff=2048,
                batch=32, src=128, tgt=128, steps=6, fp16_steps=40,
                enc_width=(768, 12, 3072), enc_layers=12, enc_batch=32,
                enc_seq=512, enc_steps=4, lstm=512, lstm_batch=16,
                lstm_src=32, beam=4, max_decode=32, lsq=(4096, 1024))
SEQ_TINY = dict(vocab=96, d_model=32, nhead=4, layers=2, ff=64, batch=4,
                src=12, tgt=10, steps=3, fp16_steps=40,
                enc_width=(32, 4, 64), enc_layers=2, enc_batch=2,
                enc_seq=16, enc_steps=2, lstm=32, lstm_batch=3,
                lstm_src=6, beam=4, max_decode=8, lsq=(64, 16))
# the small float32 copies run on the card and on the CPU (TF32 off):
# the same computation summed in other orders, ~1e-6 apart; outputs are
# held within 1e-4 and gradients within 1e-3 of each array's largest
# magnitude (``rel_err``)
SEQ_OUT_TOL, SEQ_GRAD_TOL = 1e-4, 1e-3
SEQ_LR = 5e-4


def _sinusoid(n, d):
    """Vaswani et al. 2017's positional encoding, [n, d] float32."""
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def transformer_base(paddle, vocab, d_model, nhead, layers, ff, dropout):
    """``nn.Transformer`` with one embedding shared by the source, the
    target and the output projection (Vaswani et al. 2017, 3.4; drawn
    from N(0, d_model^-1/2) as in tensor2tensor), scaled by
    sqrt(d_model), plus the sinusoidal positions (512 of them);
    ``forward`` returns the mean cross-entropy of the target tokens."""
    nn = paddle.nn

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, d_model, weight_attr=(
                paddle.ParamAttr(initializer=nn.initializer.Normal(
                    0.0, d_model ** -0.5))))
            self.transformer = nn.Transformer(d_model, nhead, layers, layers,
                                              ff, dropout)
            self.register_buffer("pe", paddle.to_tensor(
                _sinusoid(512, d_model)), persistable=False)

        def embed(self, ids):
            n = ids.shape[1]
            return self.emb(ids) * math.sqrt(d_model) + self.pe[:n]

        def forward(self, src, tgt, labels):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            h = self.transformer(self.embed(src), self.embed(tgt),
                                 tgt_mask=mask)
            logits = paddle.matmul(h, self.emb.weight, transpose_y=True)
            return paddle.nn.functional.cross_entropy(
                paddle.reshape(logits, [-1, vocab]),
                paddle.reshape(labels, [-1]))

    return TransformerBase()


def fused_encoder(paddle, width, layers, dropout):
    """``layers`` x ``incubate.nn.FusedTransformerEncoderLayer``; the
    loss is the mean square error to a target."""
    nn = paddle.nn
    E, H, F = width

    class FusedEncoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.layers = nn.LayerList([
                paddle.incubate.nn.FusedTransformerEncoderLayer(
                    E, H, F, dropout_rate=dropout)
                for _ in range(layers)])

        def forward(self, x, target):
            for layer in self.layers:
                x = layer(x)
            return paddle.mean(paddle.square(x - target))

    return FusedEncoder()


def lstm_seq2seq(paddle, vocab, width):
    """An LSTM encoder (2 layers) and an ``LSTMCell`` decoder over one
    embedding, an output projection to the vocabulary."""
    nn = paddle.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, width)
            self.encoder = nn.LSTM(width, width, num_layers=2)
            self.cell = nn.LSTMCell(width, width)
            self.out = nn.Linear(width, vocab)

        def decode(self, src, beam, max_steps):
            _, (h, c) = self.encoder(self.emb(src))
            dec = nn.BeamSearchDecoder(self.cell, start_token=0,
                                       end_token=1, beam_size=beam,
                                       embedding_fn=self.emb,
                                       output_fn=self.out)
            return nn.dynamic_decode(dec, (h[-1], c[-1]),
                                     max_step_num=max_steps)

    return Seq2Seq()


def tie_cell(paddle, vocab, rows):
    """A step cell whose logits are row ``token % rows`` of a table with
    exact ties (``tests/test_torch_rnn_transformer.py``'s ``_tie_table``
    when ``rows == vocab``): the start token's row ties every token,
    end_token (1) is likely from the other rows, row 2 rarely ends and
    ties among tokens 3.. instead; the state passes through.  Finished
    beams then extend with end_token at cost 0 beside ``-inf`` elsewhere,
    so the top k meets ties at every step."""
    t = np.full((rows, vocab), -2.0, np.float32)
    t[:, 1] = 0.0
    t[0, :] = 0.0
    t[2, 1] = -8.0
    t[2, 3:] = 1.0

    class TieCell(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.table = self.create_parameter(
                list(t.shape),
                default_initializer=paddle.nn.initializer.Assign(t))

        def forward(self, inputs, states):
            return paddle.gather(self.table, inputs % rows), states

    return TieCell()


def tie_decode(paddle, dev, vocab, rows, beam, batch, max_steps, what):
    """``dynamic_decode`` over ``tie_cell`` on the CPU and on ``dev``:
    the ids and lengths equal, and (where the vocabulary has more tokens
    than the beam) every beam finished before ``max_steps``.  Returns the
    steps run and the beams that emitted end_token."""
    res = {}
    for where in ("cpu", dev):
        paddle.set_device(where)
        dec = paddle.nn.BeamSearchDecoder(tie_cell(paddle, vocab, rows), 0,
                                          1, beam)
        ids, lens = paddle.nn.dynamic_decode(
            dec, paddle.zeros([batch, 2]), max_step_num=max_steps)
        res[str(where)] = (ids.numpy(), lens.numpy())
    (ci, cl), (di, dl) = res["cpu"], res[str(dev)]
    check(np.array_equal(ci, di) and np.array_equal(cl, dl),
          f"{what}: the card's ids {di.tolist()} / lengths {dl.tolist()} "
          f"differ from the CPU's {ci.tolist()} / {cl.tolist()}")
    finished = int((di == 1).any(axis=1).sum())
    if vocab > beam:
        check(di.shape[1] < max_steps and finished == batch * beam,
              f"{what}: {finished} of {batch * beam} beams finished in "
              f"{di.shape[1]} steps")
    return dict(steps=int(di.shape[1]), finished_beams=finished,
                beams=batch * beam)


def card_vs_cpu(torch, paddle, build, run, dev, what):
    """``build()`` at seed 0 on the CPU, again on ``dev`` with the CPU
    copy's weights; ``run(model)`` (forward and backward, inputs made on
    the current place) returns its outputs.  Outputs within
    ``SEQ_OUT_TOL`` and every parameter's gradient within
    ``SEQ_GRAD_TOL`` of the CPU's (``rel_err``); returns the worst of
    each."""
    res = {}
    for where in ("cpu", dev):
        paddle.set_device(where)
        paddle.seed(0)
        m = build()
        if where != "cpu":
            m.set_state_dict({k: v._t for k, v in ref.state_dict().items()})
        else:
            ref = m
        outs = run(m)
        res[str(where)] = (
            [o._t.detach().float().cpu() if hasattr(o, "_t")
             else o.detach().float().cpu() for o in outs],
            {k: v.grad._t.float().cpu() for k, v in m.state_dict().items()
             if v.grad is not None})
    (co, cg), (do, dg) = res["cpu"], res[str(dev)]
    check(sorted(cg) == sorted(dg) and len(cg) > 0,
          f"{what}: grads on {sorted(dg)} vs the CPU's {sorted(cg)}")
    out_err = max(rel_err(a, b) for a, b in zip(do, co))
    grad_err = max(rel_err(dg[k], cg[k]) for k in cg)
    check(out_err <= SEQ_OUT_TOL, f"{what}: outputs rel err {out_err}")
    check(grad_err <= SEQ_GRAD_TOL, f"{what}: grads rel err {grad_err}")
    return out_err, grad_err


def seq_small_checks(torch, paddle, dev):
    """Each path of ``seq_phase`` as a small float32 copy on ``dev`` and
    on the CPU (``card_vs_cpu``); the beam search's tokens and lengths
    equal, also over the CPU tests' tie tables (``tie_decode``), LBFGS's
    solutions within the reference test's 1e-3."""
    out = {}
    V = 64

    def run_tf(m):
        src = paddle.to_tensor(_ids(V, (3, 7), 0))
        tgt = paddle.to_tensor(_ids(V, (3, 5), 1))
        loss = m(src, tgt, paddle.to_tensor(_ids(V, (3, 5), 2)))
        loss.backward()
        return [loss]
    out["transformer"] = card_vs_cpu(
        torch, paddle, lambda: transformer_base(paddle, V, 32, 4, 2, 64, 0.0),
        run_tf, dev, "small transformer")

    def run_enc(m):
        rng = np.random.default_rng(3)
        x = paddle.to_tensor(rng.standard_normal((2, 6, 32)).astype(
            np.float32))
        t = paddle.to_tensor(rng.standard_normal((2, 6, 32)).astype(
            np.float32))
        loss = m(x, t)
        loss.backward()
        return [loss]
    out["fused_encoder"] = card_vs_cpu(
        torch, paddle, lambda: fused_encoder(paddle, (32, 4, 64), 2, 0.0),
        run_enc, dev, "small fused encoder")

    def run_lstm(m):
        seq, (h, c) = m.encoder(m.emb(paddle.to_tensor(_ids(V, (3, 6), 4))))
        paddle.sum(seq * seq).backward()
        with paddle.no_grad():
            ids, lens = m.decode(paddle.to_tensor(_ids(V, (3, 6), 5)), 4, 8)
        run_lstm.decoded.append((ids.numpy(), lens.numpy()))
        return [seq, h, c]
    run_lstm.decoded = []
    out["lstm"] = card_vs_cpu(torch, paddle,
                              lambda: lstm_seq2seq(paddle, V, 32),
                              run_lstm, dev, "small lstm seq2seq")
    (ci, cl), (di, dl) = run_lstm.decoded
    check(np.array_equal(ci, di) and np.array_equal(cl, dl),
          f"small beam search: the card's tokens {di.tolist()} differ from "
          f"the CPU's {ci.tolist()}")
    out["tie_decode"] = [tie_decode(paddle, dev, v, v, beam, 2, 8,
                                    f"small tie beam search V {v}")
                         for v, beam in ((6, 3), (3, 4))]
    sols = [lbfgs_lstsq(torch, paddle, where, (64, 16))
            for where in ("cpu", dev)]
    lb_err = float(np.abs(sols[0]["x"] - sols[1]["x"]).max())
    check(lb_err <= 1e-3, f"small lbfgs: card vs cpu |diff| {lb_err}")
    out["lbfgs"] = (lb_err, sols[1]["err_vs_lstsq"])
    paddle.set_device(dev)
    return out


def lbfgs_lstsq(torch, paddle, where, shape):
    """LBFGS with the strong-Wolfe search on ||A x - b||^2 (A, b from a
    seeded generator on the host, f32) against ``torch.linalg.lstsq``'s
    x: within the reference test's 1e-3 (``tests/test_optimizer_
    distribution_extras.py``)."""
    paddle.set_device(where)
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(*shape, generator=gen)
    b = torch.randn(shape[0], generator=gen)
    dev = _device(torch, where)
    A, b = A.to(dev), b.to(dev)
    x_ref = torch.linalg.lstsq(A, b.unsqueeze(1)).solution.squeeze(1)
    x = paddle.to_tensor(torch.zeros(shape[1], device=dev))
    x.stop_gradient = False
    opt = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=30,
                                 parameters=[x],
                                 line_search_fn="strong_wolfe")
    At, bt = paddle.Tensor(A), paddle.Tensor(b)
    calls = []

    def closure():
        opt.clear_grad()
        r = paddle.matmul(At, x) - bt
        loss = paddle.sum(r * r)
        loss.backward()
        calls.append(1)
        return loss

    _sync(torch, dev)
    t0 = time.perf_counter()
    loss = opt.step(closure)
    _sync(torch, dev)
    ms = 1e3 * (time.perf_counter() - t0)
    err = (x._t.detach() - x_ref).abs().max().item()
    check(err <= 1e-3, f"lbfgs on {where}: |x - lstsq| {err} > 1e-3")
    ref_loss = ((A @ x_ref - b) ** 2).sum().item()
    return dict(err_vs_lstsq=err, loss=loss.item(), lstsq_loss=ref_loss,
                closure_calls=len(calls), ms=ms,
                x=x._t.detach().cpu().numpy(), shape=list(shape))


# a profiled sequence step's device rows by class (first match wins)
SEQ_CLASSES = (
    ("cuBLAS GEMMs", r"nvjet|gemm|cublas|splitKreduce|cutlass|xmma"),
    ("softmax / cross-entropy", r"(?i)softmax|nll_loss"),
    ("casts and copies", r"(?i)copy_kernel|memcpy|memset"),
    ("elementwise / reduction", r"at::native|elementwise|reduce|CatArray"
                                r"|index"),
)


def _snapshot(torch, params):
    return [p._t.detach().clone() for p in params]


def seq_phase(torch, card, device="cuda"):
    """The item-3 paths at their published widths (``SEQ_FULL``).

    - Transformer-base (``transformer_base``: d 512, 8 heads, 6 + 6
      layers, FFN 2048, dropout 0.1, a shared 37,000-token vocabulary)
      trained with Adam(5e-4) under ``auto_cast(level="O1",
      dtype="bfloat16")`` at B 32 x 128 source and 128 target tokens for
      ``steps`` steps: step ms (steps 2 on) and tokens/s; the loss finite
      and falling; one more step profiled by class (``SEQ_CLASSES``).
    - The same model under ``auto_cast(dtype="float16")`` with
      ``GradScaler(init_loss_scaling=2**32)``: the scaler halves on real
      fp16 overflows until a step is finite, then steps on; every
      parameter bit-unchanged across each skipped step, the scale
      trajectory printed, ``amp_skipped_steps_total`` (FLAGS_tpu_metrics
      on) equal to the skipped steps.
    - ERNIE-base's width through ``incubate``: 12 x
      ``FusedTransformerEncoderLayer(768, 12, 3072)`` at B 32 x 512 (a
      regression to a random target), ``LookAhead(AdamW, k=2)`` and
      ``ModelAverage`` under O1: step ms, one more step profiled by
      class; ``ModelAverage.apply`` swaps the average in and restores the
      weights bit for bit.
    - An LSTM seq2seq (``lstm_seq2seq``: ``nn.LSTM(512, 512,
      num_layers=2)`` over a 32-token source, ``LSTMCell(512, 512)`` in a
      ``BeamSearchDecoder`` with beam 4, ``dynamic_decode`` for at most
      32 steps, B 16, vocabulary 37,000): the card's tokens and lengths
      equal the CPU's on the same seed-0 weights; the decode step ms and
      the beams that finished.  Then the same search over ``tie_cell``
      (8 rows of exact ties over the 37,000 tokens), whose beams all
      finish early: ids and lengths equal the CPU's, so the top k breaks
      ties as it does there.
    - LBFGS with the strong-Wolfe search on a 4096 x 1024 float32 least
      squares problem: within 1e-3 of ``torch.linalg.lstsq``'s solution.

    Then every path as a small float32 copy on the card and on the CPU
    (``seq_small_checks``).  ``device="cpu"`` runs ``SEQ_TINY`` (the
    rehearsal; the small checks then run CPU against CPU)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import flags as tflags
    from paddle_tpu_torch.profiler import metrics as tmetrics
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    z = SEQ_FULL if on_card else SEQ_TINY
    t_phase = time.perf_counter()
    out = {}
    V, Bt, Ss, St = z["vocab"], z["batch"], z["src"], z["tgt"]

    def tf_batch():
        return [paddle.to_tensor(_ids(V, shape, seed)) for shape, seed in
                (((Bt, Ss), 10), ((Bt, St), 11), ((Bt, St), 12))]

    # -- Transformer-base under O1 bf16
    paddle.set_device(dev)
    paddle.seed(0)
    model = transformer_base(paddle, V, z["d_model"], z["nhead"],
                             z["layers"], z["ff"], 0.1)
    n_params = sum(p.size for p in model.parameters())
    opt = paddle.optimizer.Adam(SEQ_LR, parameters=model.parameters())
    src, tgt, lab = tf_batch()
    losses, ms = [], []
    for k in range(z["steps"]):
        _sync(torch, dev)
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(src, tgt, lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        if k:
            ms.append(1e3 * (time.perf_counter() - t0))
    check(all(math.isfinite(x) for x in losses),
          f"transformer O1: losses {losses}")
    check(losses[-1] < losses[0], f"transformer O1: no fall {losses}")
    tf_ms = float(np.mean(ms))

    def tf_step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(src, tgt, lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        loss.item()
    prof = _profile_step(torch, tf_step, f"profile transformer O1 [{card}]"
                         f": 1 step, B {Bt} x {Ss} + {St}", SEQ_CLASSES,
                         {}) if on_card else None
    out["transformer_o1"] = dict(profile=prof,
        losses=losses, step_ms=tf_ms, step_ms_each=ms,
        tokens_per_s=Bt * (Ss + St) / (tf_ms / 1e3),
        target_tokens_per_s=Bt * St / (tf_ms / 1e3), n_params=n_params,
        shape=dict(B=Bt, src=Ss, tgt=St, d_model=z["d_model"],
                   layers=z["layers"], vocab=V))
    del model, opt, loss
    if on_card:
        gc_cuda(torch)
    print(f"[{time.perf_counter() - t_phase:.1f} s] seq: transformer O1")

    # -- the same model, fp16 under a GradScaler from 2**32
    paddle.seed(0)
    model = transformer_base(paddle, V, z["d_model"], z["nhead"],
                             z["layers"], z["ff"], 0.1)
    params = model.parameters()
    opt = paddle.optimizer.Adam(SEQ_LR, parameters=params)
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 32)
    tmetrics.reset()
    tflags.set_flags({"FLAGS_tpu_metrics": True})
    scales, skipped, unchanged, fp16_losses, taken = [], [], [], [], 0
    try:
        for k in range(z["fp16_steps"]):
            before = _snapshot(torch, params)
            with paddle.amp.auto_cast(dtype="float16"):
                loss = model(src, tgt, lab)
            scaler.scale(loss).backward()
            scaler.step(opt)
            skip = scaler._found_inf
            scaler.update()
            opt.clear_grad()
            fp16_losses.append(loss.item())
            scales.append(scaler.get_init_loss_scaling())
            skipped.append(skip)
            if skip:
                unchanged.append(all(torch.equal(a, p._t) for a, p in
                                     zip(before, params)))
            else:
                taken += 1
            del before
            if taken >= 2:
                break
        snap = tmetrics.snapshot()
    finally:
        tflags.set_flags({"FLAGS_tpu_metrics": False})
    n_skip = sum(skipped)
    counted = snap.get("amp_skipped_steps_total", 0)
    check(n_skip >= 1 and taken >= 2,
          f"fp16 scaler: {n_skip} skipped, {taken} taken in "
          f"{len(skipped)} steps; scales {scales}")
    check(all(unchanged), f"fp16 scaler: a skipped step changed the "
          f"parameters ({unchanged})")
    check(counted == n_skip, f"fp16 scaler: amp_skipped_steps_total "
          f"{counted} vs {n_skip} skipped")
    want, s_ = [], 2.0 ** 32
    for skip in skipped:
        s_ = s_ / 2 if skip else s_
        want.append(s_)
    check(scales == want, f"fp16 scaler: scales {scales}, not halved on "
          f"each overflow and kept otherwise ({want})")
    out["fp16_scaler"] = dict(scales=scales, skipped=skipped,
                              skipped_steps=n_skip,
                              amp_skipped_steps_total=counted,
                              losses=fp16_losses)
    tmetrics.reset()
    del model, opt, params, scaler, loss
    if on_card:
        gc_cuda(torch)
    print(f"[{time.perf_counter() - t_phase:.1f} s] seq: fp16 scaler, "
          f"scales {scales}")

    # -- the incubate fused encoder at ERNIE-base's width
    paddle.seed(0)
    enc = fused_encoder(paddle, z["enc_width"], z["enc_layers"], 0.1)
    eparams = enc.parameters()
    inner = paddle.optimizer.AdamW(SEQ_LR, parameters=eparams)
    look = paddle.incubate.LookAhead(inner, alpha=0.5, k=2)
    avg = paddle.incubate.ModelAverage(0.15, parameters=eparams,
                                       max_average_window=10)
    E = z["enc_width"][0]
    rng = np.random.default_rng(13)
    shape = (z["enc_batch"], z["enc_seq"], E)
    x = paddle.to_tensor(rng.standard_normal(shape).astype(np.float32))
    target = paddle.to_tensor(rng.standard_normal(shape).astype(np.float32))
    elosses, ems = [], []
    for k in range(z["enc_steps"]):
        _sync(torch, dev)
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = enc(x, target)
        loss.backward()
        look.step()
        avg.step()
        look.clear_grad()
        elosses.append(loss.item())
        if k:
            ems.append(1e3 * (time.perf_counter() - t0))

    def enc_step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = enc(x, target)
        loss.backward()
        look.step()
        avg.step()
        look.clear_grad()
        loss.item()
    eprof = _profile_step(torch, enc_step, f"profile fused encoder [{card}]"
                          f": 1 step, B {shape[0]} x {shape[1]}",
                          SEQ_CLASSES, {}) if on_card else None
    before = _snapshot(torch, eparams)
    with avg.apply():
        swapped = not all(torch.equal(a, p._t)
                          for a, p in zip(before, eparams))
    restored = all(torch.equal(a, p._t) for a, p in zip(before, eparams))
    check(all(math.isfinite(v) for v in elosses),
          f"fused encoder: losses {elosses}")
    check(swapped and restored, f"fused encoder: ModelAverage apply "
          f"swapped {swapped}, restored {restored}")
    out["fused_encoder"] = dict(
        losses=elosses, step_ms=float(np.mean(ems)), step_ms_each=ems,
        profile=eprof,
        n_params=sum(p.size for p in eparams),
        shape=dict(B=z["enc_batch"], S=z["enc_seq"], width=z["enc_width"],
                   layers=z["enc_layers"]))
    del enc, inner, look, avg, eparams, x, target, loss, before
    if on_card:
        gc_cuda(torch)
    print(f"[{time.perf_counter() - t_phase:.1f} s] seq: fused encoder")

    # -- the LSTM seq2seq with beam search, the card against the CPU
    decoded = {}
    src_ids = _ids(V, (z["lstm_batch"], z["lstm_src"]), 14)
    for where in ("cpu", dev):
        paddle.set_device(where)
        paddle.seed(0)
        s2s = lstm_seq2seq(paddle, V, z["lstm"])
        if where == "cpu":
            weights = {k: v._t for k, v in s2s.state_dict().items()}
        else:
            s2s.set_state_dict(weights)
        wdev = _device(torch, where)
        with paddle.no_grad():
            s = paddle.to_tensor(src_ids)
            s2s.decode(s, z["beam"], 2)                    # warm-up
            _sync(torch, wdev)
            t0 = time.perf_counter()
            ids, lens = s2s.decode(s, z["beam"], z["max_decode"])
            _sync(torch, wdev)
        decoded[str(where)] = (ids.numpy(), lens.numpy(),
                               1e3 * (time.perf_counter() - t0))
        del s2s
    (ci, cl, cms), (di, dl, dms) = decoded["cpu"], decoded[str(dev)]
    check(np.array_equal(ci, di) and np.array_equal(cl, dl),
          "beam search: the card's tokens differ from the CPU's")
    T = di.shape[1]
    out["lstm_beam"] = dict(
        steps=T, decode_ms=dms, decode_step_ms=dms / T, cpu_decode_ms=cms,
        tokens_equal_cpu=True, lengths=dl.tolist()[:2],
        finished_beams=int((di == 1).any(axis=1).sum()),
        shape=dict(B=z["lstm_batch"], src=z["lstm_src"], beam=z["beam"],
                   width=z["lstm"], vocab=V))
    del weights
    # the top k's order of ties at the full vocabulary: beams that finish
    out["tie_decode"] = tie_decode(paddle, dev, V, 8, z["beam"],
                                   z["lstm_batch"], z["max_decode"],
                                   "tie beam search")
    paddle.set_device(dev)
    print(f"[{time.perf_counter() - t_phase:.1f} s] seq: lstm beam search")

    # -- LBFGS on a least-squares problem
    out["lbfgs"] = {k: v for k, v in lbfgs_lstsq(
        torch, paddle, dev, z["lsq"]).items() if k != "x"}

    # -- the small float32 copies, card against CPU
    out["small"] = seq_small_checks(torch, paddle, dev)
    paddle.set_device(dev)
    if on_card:
        gc_cuda(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"seq [{card}]: {json.dumps(out)}")
    print(f"seq [{card}]: Transformer-base O1 {tf_ms:.2f} ms a step "
          f"({out['transformer_o1']['tokens_per_s']:.0f} tokens/s); fp16 "
          f"scaler {n_skip} skipped, scales {scales}; fused encoder "
          f"{out['fused_encoder']['step_ms']:.2f} ms a step; beam search "
          f"{out['lstm_beam']['decode_step_ms']:.3f} ms a step, "
          f"{out['lstm_beam']['finished_beams']} beams finished; tie search "
          f"{out['tie_decode']['finished_beams']} of "
          f"{out['tie_decode']['beams']} beams finished in "
          f"{out['tie_decode']['steps']} steps; LBFGS "
          f"|x - lstsq| {out['lbfgs']['err_vs_lstsq']:.3g} in "
          f"{out['lbfgs']['ms']:.1f} ms")
    return out


def _file_digest(path):
    import hashlib
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def ledger_phase(train_res, serve_res, card):
    """The train and serve result lines as perf-ledger rows
    (``from_bench_result`` / ``from_bench_serve_result``), appended to a
    temporary file, loaded back and gated by ``check``; both rows must
    say ``real_device``.  The refusal is probed on stand-ins, never on
    the repository's ``PERF_LEDGER.jsonl``: ``append`` must refuse a
    file of that name, and the file ``ledger.PROTECTED`` names (pointed
    for the probe at a copy under another name).  The repository's file
    must keep its bytes."""
    import shutil
    import tempfile
    from paddle_tpu_torch.profiler import ledger
    repo_ledger = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "PERF_LEDGER.jsonl")
    before = _file_digest(repo_ledger)
    rows = [ledger.from_bench_result(train_res, cmd="chip_smoke.py"),
            ledger.from_bench_serve_result(serve_res, cmd="chip_smoke.py")]
    with tempfile.TemporaryDirectory(prefix="ledger_smoke_") as d:
        by_name = os.path.join(d, "PERF_LEDGER.jsonl")
        stand_in = os.path.join(d, "protected.jsonl")
        if before is not None:
            shutil.copyfile(repo_ledger, stand_in)
        else:
            open(stand_in, "w").close()
        stand_in_before = _file_digest(stand_in)
        refused = {}
        protected = ledger.PROTECTED
        ledger.PROTECTED = stand_in
        try:
            for what, target in (("by_name", by_name),
                                 ("protected", stand_in)):
                try:
                    ledger.append(target, rows[0])
                    refused[what] = False
                except ValueError:
                    refused[what] = True
        finally:
            ledger.PROTECTED = protected
        untouched = (not os.path.exists(by_name)
                     and _file_digest(stand_in) == stand_in_before)
        path = os.path.join(d, "ledger.jsonl")
        for r in rows:
            ledger.append(path, r)
        back = ledger.load(path)
        verdict = ledger.check(back)
    check(all(refused.values()), f"ledger: append did not refuse {refused}")
    check(untouched, "ledger: a refused append wrote its stand-in")
    check(len(back) == 2 and all(r["provenance"]["real_device"]
                                 for r in back),
          f"ledger: rows {[r['provenance'] for r in back]}")
    check(verdict["ok"], f"ledger: check {verdict}")
    check(_file_digest(repo_ledger) == before,
          "ledger: PERF_LEDGER.jsonl changed")
    out = dict(rows=len(back), sources=[r["source"] for r in back],
               metrics=[r["metrics"] for r in back],
               real_device=[r["provenance"]["real_device"] for r in back],
               check_ok=verdict["ok"], refused=refused,
               repo_ledger_unchanged=True)
    print(f"ledger [{card}]: {json.dumps(out)}")
    return out


# jit / static / asp / the eager MoE layer (jit_static_phase)
JIT_STATIC_STEPS = 3
JIT_TURNS = 3           # eager / to_static forward turns, alternating
JIT_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=2, max_position_embeddings=64,
                 dtype=None, fused_blocks="on")
# the eager MoELayer at llama1b's MoE width: d_model, experts, FFN, top k,
# tokens [B, S]; float32 (the reference's default)
MOE_LAYER_FULL = dict(d=2048, experts=8, ffn=5504, top_k=2, B=4, S=2048)
MOE_LAYER_TINY = dict(d=16, experts=4, ffn=32, top_k=2, B=2, S=8)
JIT_ROWS = ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd")
JIT_LOAD_SCRIPT = r"""
import hashlib, json, sys, time
import numpy as np, torch
t0 = time.perf_counter()
import paddle_tpu_torch as paddle
from paddle_tpu_torch import bench, inference
assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
ids_path, device, turns, *prefixes = sys.argv[1:]
paddle.set_device(device)
ids = np.load(ids_path)


def sync():
    if device != "cpu":
        torch.cuda.synchronize()


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def counts():
    # the launches since the last call (the counts then set to 0)
    out = {n: w.launches for n, w in bench.KERNELS.items()}
    for w in bench.KERNELS.values():
        w.launches = 0
    return out


t1 = time.perf_counter()
import_s = t1 - t0
for prefix in prefixes:
    # the Predictor's create is jit.load's (its layer, by Config's device)
    config = inference.Config(prefix + ".pdmodel")
    if device == "cpu":
        config.disable_gpu()
    pred = inference.create_predictor(config)
    m = pred._layer
    sync()
    t2 = time.perf_counter()
    counts()
    out = m(ids)
    sync()
    t3 = time.perf_counter()
    launches = counts()
    print("JIT_LOAD", digest(out._t.cpu().numpy()), import_s, t2 - t1,
          t3 - t2, " ".join(f"{n}={c}" for n, c in launches.items()))
    del out
    # the Predictor: positional, the handle protocol, clone()
    got = pred.run([ids])[0]
    run_launches = counts()
    d_run = digest(got)
    del got
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids)
    pred.run()
    d_handles = digest(pred.get_output_handle(
        pred.get_output_names()[0]).copy_to_cpu())
    d_clone, clone_s = None, None
    if prefix == prefixes[0]:       # clone() on the first artifact
        t4 = time.perf_counter()
        twin = pred.clone()
        clone_s = time.perf_counter() - t4
        d_clone = digest(twin.run([ids])[0])
        del twin
    run_ms, fwd_ms = [], []
    # the first artifact's turns in full, the second's two
    for _ in range(int(turns) if prefix == prefixes[0] else 2):
        sync()
        t5 = time.perf_counter()
        pred.run([ids])
        run_ms.append(1e3 * (time.perf_counter() - t5))
        sync()
        t5 = time.perf_counter()
        out = m(ids)
        sync()
        fwd_ms.append(1e3 * (time.perf_counter() - t5))
        del out
    print("PREDICTOR", json.dumps(dict(
        digest_run=d_run, digest_handles=d_handles, digest_clone=d_clone,
        launches=run_launches, clone_s=clone_s, run_ms=run_ms,
        load_forward_ms=fwd_ms)))
    del m, pred, h
    t1 = time.perf_counter()
"""


# Predictor.run turns over bench.py's Llama, and the C host's runs
PREDICTOR_TURNS, CAPI_RUNS = 5, 2


def capi_host_run(ids_np, prefix, tmp, want_digest, want_shape, on_card):
    """The port's C library and ``capi/capi_host.c`` built with ``g++``
    into ``tmp``, and the host run on ``prefix``'s artifact with
    ``ids_np``: ``CAPI_RUNS`` runs, then a call with a negative
    dimension.  Its logits' SHA-256 must be ``want_digest`` (their shape
    ``want_shape``, float32), the negative dimension must come back as
    an error through ``PD_GetLastError`` and the host exit 0.  Returns
    its build, create and run times, its launches (the library's
    ``PADDLE_TPU_CAPI_LAUNCHES`` file) and the logits' bytes."""
    from paddle_tpu_torch.inference import capi
    t0 = time.perf_counter()
    lib = capi.build(out_dir=tmp)
    host = capi.build_host(os.path.join(capi.CAPI_DIR, "capi_host.c"),
                           os.path.join(tmp, "capi_host"), lib)
    build_s = time.perf_counter() - t0
    ids_bin = os.path.join(tmp, "ids.bin")
    np.ascontiguousarray(ids_np, np.int64).tofile(ids_bin)
    env = capi.host_env(None if on_card else "cpu")
    env["PADDLE_TPU_CAPI_LAUNCHES"] = os.path.join(tmp, "launches.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [host, prefix, ids_bin, "3", "2", *map(str, ids_np.shape),
         str(CAPI_RUNS), "--badshape"], capture_output=True, text=True,
        env=env, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"C host: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rows = [ln.split() for ln in proc.stdout.splitlines()]
    runs = [float(r[1]) for r in rows if r[0] == "RUN_MS"]
    outs = [r for r in rows if r[0] == "OUTPUT"]
    bad = [" ".join(r[1:]) for r in rows if r[0] == "BADSHAPE"]
    check(len(runs) == CAPI_RUNS and len(outs) == 1,
          f"C host: {proc.stdout[-2000:]}")
    check(outs[0][-1] == want_digest, "C host: its logits' SHA-256 "
          "differs from the eager forward's")
    shape = [int(d) for d in outs[0][4:-2]]
    check(shape == want_shape and outs[0][2] == "0",
          f"C host: output {outs[0]} vs {want_shape} float32")
    check(len(bad) == 1 and "shape" in bad[0],
          f"C host: the negative dimension was not refused: {bad}")
    with open(env["PADDLE_TPU_CAPI_LAUNCHES"]) as f:
        launches = json.load(f)
    return dict(build_s=build_s, wall_s=wall,
                create_s=float(next(r[1] for r in rows
                                    if r[0] == "CREATE_S")),
                run_ms_each=runs, run_ms=float(np.median(runs)),
                logits_bit_equal=True, bad_shape_error=bad[0],
                launches=launches,
                logit_bytes=int(np.prod(shape)) * 4)


def cf_probe(x, n):
    """A function with a tensor-predicated ``if`` and ``while`` (the
    dy2static pass lowers them to ``torch.cond`` / ``while_loop``)."""
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = -x
    i = n - n
    while i < n:
        y = y * 1.5 + 1.0
        i = i + 1
    return y


def _digest(torch, t):
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _archive_tensor_bytes(path):
    """The bytes of tensor data in a ``torch.export.save`` archive: its
    members under ``data/`` but the JSON configs (weights, constants,
    example inputs)."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename
                   and not i.filename.endswith(".json"))


def _counts(kernels):
    return {n: w.launches for n, w in kernels.items()}


def _zero(kernels):
    for w in kernels.values():
        w.launches = 0


def jit_static_phase(torch, tbench, tllama, card, eager, device="cuda"):
    """``jit``, ``static``, ``incubate.asp`` and the eager ``MoELayer`` at
    full width on the card.

    bench.py's ``LlamaForCausalLM`` (B 4 x 2048, "dots", fused blocks
    "auto"; ``eager``: ``eager_phase``'s result, its step ms and peak):

    - ``jit.to_static``: logits bit-equal to the eager forward's; the
      captured graph's custom-op nodes equal the eager forward's launches
      of rows 7-9, and its replay launches them as often; one capture for
      repeated calls, one more for a new shape; the first call's capture
      seconds and the forward ms of eager and ``to_static`` in
      alternating turns.
    - ``jit.save`` at ``InputSpec([4, 2048], "int64")``, on the fused
      route and on the unfused one (fused blocks "off", the same
      weights): ``.pdiparams`` holds the parameters' bytes + < 1 MiB,
      ``.pdmodel`` no tensor bytes and custom-op nodes equal to the
      eager forward's launches (rows 7-9; unfused, row 1's
      ``flash_fwd``); ``jit.load`` of both in a fresh ``python`` that
      imports only ``paddle_tpu_torch`` gives each route's eager logits
      bits (a sha256 of them) and launches; save and load seconds.
    - in that process, ``inference.create_predictor`` over each artifact
      (the load above is the Predictor's): ``run([ids])``, the handle
      protocol and ``clone()`` (fused route) give the eager logits' bits,
      one run launches what the eager forward does; ``run`` ms over
      ``PREDICTOR_TURNS`` turns (the unfused route 2) beside the loaded
      forward's.
    - the port's C library and ``capi/capi_host.c`` built with ``g++``,
      the host run on the fused artifact once that process has ended
      (nothing else runs meanwhile): its logits' SHA-256 the eager forward's, ``CAPI_RUNS`` runs'
      launches the eager forward's times that, a negative dimension
      refused through ``PD_GetLastError``; create s and run ms.
    - ``to_static(cf_probe)`` (tensor-predicated ``if`` and ``while``) on
      a small input: the card equals the CPU, bit for bit.
    - static mode: ``enable_static()``, ``static.data`` ids and labels,
      ``loss = LlamaForCausalLM(cfg)(ids, labels)``, ``AdamW(LinearWarmup,
      ClipGradByGlobalNorm(1.0)).minimize(loss)``, ``Executor.run`` for
      ``JIT_STATIC_STEPS`` steps: step 1's loss and every grad bit-equal
      to the eager step's from the same initial state, steps 2-3's losses
      bit-equal; step ms and the peak beside the eager step's.
    - asp: ``prune_model`` on that model, ``JIT_STATIC_STEPS``
      ``asp.decorate(AdamW)`` steps; after every step each pruned
      parameter passes the 2:4 check on the device; layer 0 of ``wq``'s
      mask equals the numpy mask of the same bf16 values; the density
      and the prune seconds.
    - the eager ``MoELayer`` (``MOE_LAYER_FULL``, gshard, float32):
      ``JIT_STATIC_STEPS`` AdamW steps, the loss and aux finite, the
      experts and the gate moved; the dropped share and the step ms.

    ``device="cpu"``: ``JIT_SMALL`` (fused blocks "on": the custom ops'
    CPU registrations) at B 2 x 32 and ``MOE_LAYER_TINY``, the
    rehearsal."""
    import subprocess
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        MoELayer, moe_layer)
    from paddle_tpu_torch.jit.api import count_custom_ops
    from paddle_tpu_torch.profiler import compile_tracker
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    kernels = dict(tbench.KERNELS)
    cfg = (tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
           if on_card else tllama.LlamaConfig(
               remat_policy="dots", **dict(JIT_SMALL, dtype=torch.float32)))
    B, S = (4, tbench.SEQ) if on_card else (2, 32)
    out = {"shape": dict(B=B, S=S)}
    if on_card:
        gc_cuda(torch)
    paddle.set_device(dev)
    paddle.seed(0)
    net = tllama.LlamaForCausalLM(cfg)
    params = net.parameters()
    n_bytes = sum(p._t.numel() * p._t.element_size() for p in params)
    batch = tbench.make_batch(cfg, B, S, dev)
    ids = paddle.to_tensor(batch["input_ids"])
    labels = paddle.to_tensor(batch["labels"])

    # -- to_static: bits, nodes, launches, traces, times
    _zero(kernels)
    with paddle.no_grad():
        want = net(ids)
    _sync(torch, dev)
    eager_launch = _counts(kernels)
    compile_tracker.reset()
    paddle.jit.to_static(net)
    _zero(kernels)
    _sync(torch, dev)
    t0 = time.perf_counter()
    got = net(ids)
    _sync(torch, dev)
    capture_s = time.perf_counter() - t0
    static_launch = _counts(kernels)
    check(torch.equal(got._t, want._t), "jit: to_static's logits differ "
          "from the eager forward's")
    nodes = count_custom_ops(net.forward)
    want_nodes = {n: eager_launch[n] for n in JIT_ROWS if eager_launch[n]}
    if on_card:
        check(nodes == want_nodes and len(want_nodes) == 3,
              f"jit: custom-op nodes {nodes} vs the eager forward's "
              f"launches {want_nodes}")
        check(static_launch == eager_launch, f"jit: the replay launched "
              f"{static_launch}, the eager forward {eager_launch}")
    else:
        check(nodes == {n: cfg.num_hidden_layers for n in JIT_ROWS},
              f"jit: custom-op nodes {nodes}")
    net(ids)
    traces = dict(compile_tracker.stats()["functions"])
    check(list(traces.values()) == [{"traces": 1, "retraces": 0}],
          f"jit: repeated calls captured again: {traces}")
    half = paddle.to_tensor(batch["input_ids"][: B // 2])
    net(half)
    fn = compile_tracker.stats()["functions"]["LlamaForCausalLM.forward"]
    check(fn == {"traces": 2, "retraces": 1},
          f"jit: a new shape did not capture once more: {fn}")
    del half
    static_fwd = net.forward
    eager_fwd = type(net).forward.__get__(net)
    turns = {"eager": [], "to_static": []}
    with paddle.no_grad():
        for _ in range(JIT_TURNS):
            for name, f in (("eager", eager_fwd), ("to_static", static_fwd)):
                _sync(torch, dev)
                t0 = time.perf_counter()
                f(ids)
                _sync(torch, dev)
                turns[name].append(1e3 * (time.perf_counter() - t0))
    out["to_static"] = dict(
        logits_bit_equal=True, custom_op_nodes=nodes,
        eager_forward_launches=eager_launch, replay_launches=static_launch,
        traces=fn, capture_s=capture_s,
        forward_ms={k: float(np.median(v)) for k, v in turns.items()},
        forward_ms_each=turns)

    net.__dict__.pop("forward")
    del got, static_fwd, eager_fwd

    # -- jit.save of both routes, jit.load of both in one fresh process.
    # The unfused route (fused blocks "off" on the same weights) holds
    # rows 1-2's ``flash_fwd`` nodes, which the fused route runs inside
    # row 8's call.
    route = cfg.fused_blocks
    cfg.fused_blocks = "off"
    _zero(kernels)
    with paddle.no_grad():
        want_off = net(ids)
    _sync(torch, dev)
    off_launch = _counts(kernels)
    cfg.fused_blocks = route
    routes = {"fused": (want, eager_launch), "unfused": (want_off,
                                                          off_launch)}
    ids_np = batch["input_ids"].cpu().numpy()
    saved, nodes_saved = {}, {}
    # the ~1.9 GB artifacts go with the directory, whatever a gate says
    with tempfile.TemporaryDirectory(prefix="jit_smoke_",
                                     dir=os.getcwd()) as tmp:
        prefixes = []
        for name in routes:
            prefix = os.path.join(tmp, name)
            cfg.fused_blocks = "off" if name == "unfused" else route
            t0 = time.perf_counter()
            paddle.jit.save(net, prefix, input_spec=[paddle.jit.InputSpec(
                [B, S], "int64")])
            save_s = time.perf_counter() - t0
            cfg.fused_blocks = route
            sizes = {ext: os.path.getsize(prefix + ext)
                     for ext in (".pdmodel", ".pdiparams", ".meta")}
            check(n_bytes <= sizes[".pdiparams"] < n_bytes + (1 << 20),
                  f"jit.save ({name}): .pdiparams {sizes['.pdiparams']} B "
                  f"for {n_bytes} B of parameters")
            held = _archive_tensor_bytes(prefix + ".pdmodel")
            check(held == 0, f"jit.save ({name}): .pdmodel holds {held} B "
                  f"of tensors")
            with open(prefix + ".pdmodel", "rb") as f:
                nodes_saved[name] = count_custom_ops(torch.export.load(f))
            saved[name] = dict(save_s=save_s, bytes=sizes)
            prefixes.append(prefix)
        ids_path = os.path.join(tmp, "ids.npy")
        np.save(ids_path, ids_np)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", JIT_LOAD_SCRIPT, ids_path,
             "gpu" if on_card else "cpu", str(PREDICTOR_TURNS),
             *prefixes],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        load_wall = time.perf_counter() - t0
        # the C host on the fused artifact, in a process of its own
        # once the fresh process has ended
        capi_host = capi_host_run(ids_np, prefixes[0], tmp,
                                  _digest(torch, want._t),
                                  list(want.shape), on_card)
    lines = [ln.split() for ln in res.stdout.splitlines()
             if ln.startswith("JIT_LOAD")]
    preds = [json.loads(ln.split(" ", 1)[1])
             for ln in res.stdout.splitlines() if ln.startswith("PREDICTOR")]
    check(res.returncode == 0 and len(lines) == len(routes) == len(preds),
          f"jit.load: the fresh process failed: {res.stderr[-2000:]}")
    for (name, (w, w_launch)), line, pr in zip(routes.items(), lines,
                                               preds):
        _, digest, import_s, load_s, run_s, *lc = line
        load_launch = {kv.split("=")[0]: int(kv.split("=")[1])
                       for kv in lc}
        want_nodes = ({n: w_launch[n] for n in JIT_ROWS} if name == "fused"
                      else {"flash_fwd": w_launch["flash_fwd"]})
        if on_card:
            check(nodes_saved[name] == want_nodes and all(
                want_nodes.values()), f"jit.save ({name}): custom-op "
                f"nodes {nodes_saved[name]} vs the eager forward's "
                f"launches {want_nodes}")
            check(load_launch == w_launch, f"jit.load ({name}): launches "
                  f"{load_launch} vs the eager forward's {w_launch}")
        else:
            check(nodes_saved[name] == {n: cfg.num_hidden_layers
                                        for n in want_nodes},
                  f"jit.save ({name}): custom-op nodes {nodes_saved[name]}")
        want_digest = _digest(torch, w._t)
        check(digest == want_digest, f"jit.load ({name}): the "
              f"fresh process's logits differ from the eager forward's")
        # the Predictor over the same artifact: bits, launches, clone
        for k in ("digest_run", "digest_handles", "digest_clone"):
            check(pr[k] == want_digest or (k == "digest_clone" and
                                           name != "fused"),
                  f"predictor ({name}): {k}'s logits differ from the "
                  f"eager forward's")
        if on_card:
            check(pr["launches"] == w_launch, f"predictor ({name}): "
                  f"launches {pr['launches']} vs the eager forward's "
                  f"{w_launch}")
        saved[name].update(
            custom_op_nodes=nodes_saved[name], eager_forward_launches=w_launch,
            launches=load_launch, logits_bit_equal=True,
            load_process=dict(import_s=float(import_s), load_s=float(load_s),
                              first_call_s=float(run_s)),
            predictor=dict(
                logits_bit_equal=True, handles_bit_equal=True,
                clone_bit_equal=name == "fused" or None,
                launches=pr["launches"],
                clone_s=pr["clone_s"], run_ms_each=pr["run_ms"],
                run_ms=float(np.median(pr["run_ms"])),
                load_forward_ms_each=pr["load_forward_ms"],
                load_forward_ms=float(np.median(pr["load_forward_ms"]))))
    out["save_load"] = dict(param_bytes=n_bytes, load_wall_s=load_wall,
                            **saved)
    save_s = saved["fused"]["save_s"]
    load_s = saved["fused"]["load_process"]["load_s"]
    del want, want_off

    # -- tensor-predicated control flow: the card against the CPU
    xs = np.random.default_rng(3).standard_normal((4, 64)).astype(
        np.float32)
    cf = {}
    for where in ("cpu", dev.type):
        paddle.set_device(where)
        f = paddle.jit.to_static(cf_probe)
        r = []
        for sign in (1.0, -1.0):
            r.append(f(paddle.to_tensor(sign * xs),
                       paddle.to_tensor(3))._t.cpu())
        cf[where] = r
        targets = [str(n.target) for n in f.program().graph.nodes]
        check(any("cond" in t for t in targets)
              and any("while_loop" in t for t in targets),
              f"jit: cf_probe captured no cond / while_loop on {where}")
    paddle.set_device(dev)
    check(all(torch.equal(a, b) for a, b in zip(cf["cpu"], cf[dev.type])),
          "jit: cf_probe on the card differs from the CPU")
    out["control_flow"] = dict(card_equals_cpu=True, shape=list(xs.shape))

    # -- eager steps from the initial state (the static run's yardstick)
    def adamw(p):
        sched = paddle.optimizer.lr.LinearWarmup(EAGER_LR, 2, EAGER_LR / 10,
                                                 EAGER_LR)
        return sched, paddle.optimizer.AdamW(
            learning_rate=sched, parameters=p,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    if on_card:
        gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    _reset_peak(torch, dev)
    sched, opt = adamw(params)
    e_losses, e_grads, e_ms = [], None, []
    for k in range(JIT_STATIC_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss, _ = net(ids, labels=labels)
        loss.backward()
        if k == 0:
            e_grads = [p.grad._t.clone() for p in params
                       if not p.stop_gradient]
        opt.step()
        opt.clear_grad()
        sched.step()
        _sync(torch, dev)
        e_ms.append(1e3 * (time.perf_counter() - t0))
        e_losses.append(loss._t.detach().clone())
        del loss
    e_peak = _peak(torch, dev) - base if on_card else None
    del net, params, opt, sched
    if on_card:
        gc_cuda(torch)

    # -- static mode: the same model and optimizer through the Executor
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    _reset_peak(torch, dev)
    paddle.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            sids = static.data("ids", [B, S], "int64")
            slab = static.data("labels", [B, S], "int64")
            snet = tllama.LlamaForCausalLM(cfg)
            sloss, _ = snet(sids, slab)
            sparams = snet.parameters()
            sched, opt = adamw(sparams)
            opt.minimize(sloss)
    finally:
        paddle.disable_static()
    n_ops = len(main._ops)
    grads = []
    step = opt.step

    def first_grads():
        if not grads:
            grads.extend(p.grad._t.clone() for p in sparams
                         if not p.stop_gradient)
        step()
    opt.step = first_grads
    exe = static.Executor()
    s_losses, s_ms = [], []
    _zero(kernels)
    feed = {"ids": batch["input_ids"], "labels": batch["labels"]}
    for k in range(JIT_STATIC_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[sloss],
                        return_numpy=False)
        sched.step()
        _sync(torch, dev)
        s_ms.append(1e3 * (time.perf_counter() - t0))
        s_losses.append(lv._t)
    s_launch = _counts(kernels)
    s_peak = _peak(torch, dev) - base if on_card else None
    opt.step = step
    same_losses = [torch.equal(a, b) for a, b in zip(s_losses, e_losses)]
    same_grads = [torch.equal(a, b) for a, b in zip(grads, e_grads)]
    check(all(same_losses), f"static: losses {[float(x) for x in s_losses]}"
          f" vs eager {[float(x) for x in e_losses]}")
    check(len(grads) == len(e_grads) and all(same_grads),
          f"static: {same_grads.count(False)} of {len(same_grads)} step-1 "
          f"grads differ from the eager step's")
    del grads, e_grads
    out["static"] = dict(
        ops=n_ops, losses=[float(x) for x in s_losses],
        step1_loss_bit_equal=True, steps_loss_bit_equal=len(same_losses),
        step1_grads_bit_equal=len(same_grads), launches=s_launch,
        step_ms=float(np.mean(s_ms[1:])), step_ms_each=s_ms,
        eager_step_ms=float(np.mean(e_ms[1:])), eager_step_ms_each=e_ms,
        eager_phase_step_ms=(eager or {}).get("llama", {}).get("step_ms"),
        peak_over_base=s_peak, eager_peak_over_base=e_peak,
        eager_phase_peak=(eager or {}).get("llama", {}).get(
            "peak_over_base"))

    # -- asp on that model
    t0 = time.perf_counter()
    masks = asp.prune_model(snet)
    _sync(torch, dev)
    prune_s = time.perf_counter() - t0
    wq = snet.layers_wq
    m0 = asp.create_mask(wq._t[0].detach().float().cpu().numpy())
    check(np.array_equal(masks["layers_wq"][0].float().cpu().numpy(), m0),
          "asp: layer 0 of wq's mask differs from the numpy mask")
    sched, opt = adamw(sparams)
    aopt = asp.decorate(opt)
    a_losses = []
    for _ in range(JIT_STATIC_STEPS):
        loss, _ = snet(ids, labels=labels)
        loss.backward()
        aopt.step()
        aopt.clear_grad()
        sched.step()
        a_losses.append(float(loss))
        bad = [n for n, p in snet.named_parameters()
               if n in masks and not asp.check_sparsity(p)]
        check(not bad, f"asp: 2:4 lost after a step in {bad[:4]}")
        del loss
    pruned = [p for n, p in snet.named_parameters() if n in masks]
    density = sum(int(torch.count_nonzero(p._t)) for p in pruned) / sum(
        p._t.numel() for p in pruned)
    check(all(math.isfinite(x) for x in a_losses), f"asp: {a_losses}")
    out["asp"] = dict(pruned=len(masks), density=density, prune_s=prune_s,
                      losses=a_losses, mask_equals_numpy=True)
    del snet, sparams, opt, aopt, sched, masks, main, exe, pruned, wq
    if on_card:
        gc_cuda(torch)

    # -- the eager MoE layer
    m = MOE_LAYER_FULL if on_card else MOE_LAYER_TINY
    nn = paddle.nn
    paddle.seed(0)
    layer = MoELayer(m["d"], [nn.Sequential(nn.Linear(m["d"], m["ffn"]),
                                            nn.GELU(),
                                            nn.Linear(m["ffn"], m["d"]))
                              for _ in range(m["experts"])],
                     gate="gshard", top_k=m["top_k"])
    before = {n: p._t.detach().clone() for n, p in layer.named_parameters()}
    mopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=layer.parameters())
    x = paddle.randn([m["B"], m["S"], m["d"]])
    m_losses, m_aux, m_ms, drops = [], [], [], []
    for _ in range(JIT_STATIC_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        y = layer(x)
        loss = paddle.mean(y * y) + layer.aux_loss
        loss.backward()
        mopt.step()
        mopt.clear_grad()
        _sync(torch, dev)
        m_ms.append(1e3 * (time.perf_counter() - t0))
        m_losses.append(float(loss))
        m_aux.append(float(layer.aux_loss))
        drops.append(moe_layer.dropped_share(layer.last_gate_idx,
                                             m["experts"],
                                             layer.capacity_factor))
        del y, loss
    moved = {n: not torch.equal(before[n], p._t)
             for n, p in layer.named_parameters()}
    check(all(math.isfinite(v) for v in m_losses + m_aux),
          f"moe layer: loss {m_losses} aux {m_aux}")
    check(all(moved.values()), "moe layer: unchanged after the steps: "
          f"{[n for n, v in moved.items() if not v][:4]}")
    out["moe_layer"] = dict(losses=m_losses, aux=m_aux, dropped_share=drops,
                            step_ms=float(np.mean(m_ms[1:])),
                            step_ms_each=m_ms, width=m)
    del layer, mopt, x, before
    if on_card:
        gc_cuda(torch)

    if on_card:
        check(capi_host["launches"] == {
            n: CAPI_RUNS * c for n, c in eager_launch.items()},
            f"C host: launches {capi_host['launches']} over "
            f"{CAPI_RUNS} runs vs the eager forward's {eager_launch}")
    out["save_load"]["capi_host"] = capi_host
    out["seconds"] = time.perf_counter() - t_phase
    print(f"jit_static [{card}]: {json.dumps(out)}")
    pf = saved["fused"]["predictor"]
    print(f"jit_static [{card}]: Predictor.run (fused) {pf['run_ms']:.2f} "
          f"ms a call (its loaded forward {pf['load_forward_ms']:.2f} ms, "
          f"the eager forward {out['to_static']['forward_ms']['eager']:.2f}"
          f" ms), unfused {saved['unfused']['predictor']['run_ms']:.2f} ms;"
          f" C host create {capi_host['create_s']:.2f} s, run "
          f"{capi_host['run_ms']:.2f} ms; logits {capi_host['logit_bytes']}"
          f" B to the host")
    print(f"jit_static [{card}]: to_static fwd "
          f"{out['to_static']['forward_ms']['to_static']:.2f} ms vs eager "
          f"{out['to_static']['forward_ms']['eager']:.2f} ms (capture "
          f"{capture_s:.2f} s); save {save_s:.2f} s, load "
          f"{float(load_s):.2f} s; static step "
          f"{out['static']['step_ms']:.2f} ms vs eager "
          f"{out['static']['eager_step_ms']:.2f} ms; moe layer step "
          f"{out['moe_layer']['step_ms']:.2f} ms; "
          f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# serving an exported model: PTQ int8 ResNet-50 through the Predictor
# ---------------------------------------------------------------------------

# ResNet-50 at the vision cell's batch and image, over seeded
# calibration batches; the CPU rehearsal's sizes
INFER_FULL = dict(image=224, batch=64, calib=4)
INFER_SMALL = dict(image=64, batch=8, calib=2)
INFER_TURNS = 3          # served batches timed, int8 and f32 alternating
# the int8 logits against the f32 ones: the largest difference over the
# largest f32 logit within quantize_serve's own bound, and the top-1
# classes mostly the same
INFER_REL_MAX, INFER_TOP1_MIN = 0.1, 0.9
# the converted artifacts' logits against the f32 Predictor's: the
# largest difference over the largest f32 logit, within the reference's
# own bounds for the two conversions (tests/test_inference_convert.py)
CONVERT_REL_MAX = {"bfloat16": 2e-2, "int8": 6e-2}
CONVERT_RATIO_MAX = {"bfloat16": 0.55, "int8": 0.35}
# QuantizedLinear's product routes: torch._int_mm (M > 16, K and N
# multiples of 8) and the float64 product off those rules
INT8_ROUTE_SHAPES = ((64, 2048, 1000), (17, 64, 8), (16, 64, 8),
                     (64, 36, 40))


def _saved_state(path):
    from paddle_tpu_torch.framework.io import load
    return {k: (v._t if hasattr(v, "_t") else v)
            for k, v in load(path).items()}


def quantize_serve_example(card, device="cuda"):
    """``python -m paddle_tpu_torch.examples.quantize_serve`` (``--device
    cpu`` off the card) in a process of its own: it exits 0 and prints
    its closing line, so its own asserts held (served within 0.1 of
    float32, the payload under 0.5x).  Returns its output's lines."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.quantize_serve",
         *(() if device == "cuda" else ("--device", device))],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0 and "int8 serving flow OK" in proc.stdout,
          f"quantize_serve: exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    print(f"quantize_serve [{card}] ({time.perf_counter() - t0:.1f} s): "
          + " | ".join(lines), flush=True)
    return lines


def inference_calibrate(torch, card, device="cuda"):
    """``inference_phase``'s first part, which needs none of the port's
    kernels (``main`` runs it while they compile): ResNet-50 built at
    ``INFER_FULL`` on the card (``INFER_SMALL`` on the CPU), PTQ's
    observation of the calibration batches (each activation copied to
    the host), then the freeze (``convert(to_int8=True)``, where the 54
    KL threshold searches run in host numpy).  Returns the state
    ``inference_phase`` takes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import quantization as Q
    dev = _device(torch, device)
    on_card = dev.type == "cuda"
    size = INFER_FULL if on_card else INFER_SMALL
    t_phase = time.perf_counter()
    if on_card:
        gc_cuda(torch)
    paddle.set_device("gpu" if on_card else "cpu")
    paddle.seed(0)
    net = paddle.vision.models.resnet50()
    net.eval()
    rng = np.random.default_rng(0)
    shape = (size["batch"], 3, size["image"], size["image"])
    batches = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(size["calib"])]
    x = rng.standard_normal(shape).astype(np.float32)

    # -- PTQ: observe, then freeze
    t0 = time.perf_counter()
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.QuanterFactory(Q.KLObserver),
                              weight=Q.QuanterFactory(Q.AbsmaxObserver)))
    observed = ptq.quantize(net)
    with paddle.no_grad():
        for b in batches:
            observed(paddle.to_tensor(b))
    _sync(torch, dev)
    observe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qnet = ptq.convert(observed, to_int8=True)
    _sync(torch, dev)
    return dict(dev=dev, net=net, qnet=qnet, x=x, shape=shape, size=size,
                observe_s=observe_s, freeze_s=time.perf_counter() - t0,
                seconds=time.perf_counter() - t_phase)


def inference_phase(torch, card, state):
    """ResNet-50 (the vision cell's model: 1000 classes, 3 x 224 x 224,
    float32, TF32 off, eval mode, weights from seed 0, ``INFER_FULL``)
    quantized after training and served; ``state``:
    ``inference_calibrate``'s.

    - PTQ as ``quantize_serve`` configures it (``KLObserver`` for the
      activations, ``AbsmaxObserver`` for the weights) over the
      calibration batches, then ``convert(to_int8=True)``: 53
      ``QuantizedConv2D`` and 1 ``QuantizedLinear`` (the fc, 2048 ->
      1000 at M = the batch: ``torch._int_mm``'s route).
    - ``jit.save`` of the float32 and the int8 model at ``InputSpec([
      batch, 3, image, image])``, each served by a ``Predictor`` on the
      card: the int8 Predictor's logits bit-equal to the quantized eager
      model's (the float32 one's to the float model's); the int8
      ``.pdiparams`` under 0.5x the float32 one's, with no float32
      convolution weight in it.  Reported: the int8 logits' relative
      error and top-1 agreement against float32, the calibration
      (observe + freeze) and save seconds, served ms a batch and
      images/s of both (``INFER_TURNS`` alternating turns).  The int8
      logits within ``INFER_REL_MAX`` of float32's, top-1 agreement at
      least ``INFER_TOP1_MIN``.
    - ``convert_to_mixed_precision`` of the float32 artifact to
      'bfloat16' and 'int8': payload ratios within
      ``CONVERT_RATIO_MAX``, each Predictor's logits within
      ``CONVERT_REL_MAX`` of the float32 Predictor's.
    - QuantizedLinear's int32 accumulator bit-equal across its routes
      (``INT8_ROUTE_SHAPES``: ``torch._int_mm``, the float64 product and
      the CPU's int32 product).

    On the CPU (``state`` from ``inference_calibrate(..., device="cpu")``)
    it is the rehearsal."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.quantization.quantized_layers import int8_product
    dev, net, qnet, x, shape = (state[k] for k in ("dev", "net", "qnet",
                                                    "x", "shape"))
    batch = shape[0]
    on_card = dev.type == "cuda"
    t_part2 = time.perf_counter()
    observe_s, convert_s = state["observe_s"], state["freeze_s"]
    out = {"shape": dict(B=batch, image=shape[2],
                         calib_batches=state["size"]["calib"])}
    kinds = [type(s).__name__ for s in qnet.sublayers()]
    n_conv, n_lin = (kinds.count("QuantizedConv2D"),
                     kinds.count("QuantizedLinear"))
    check((n_conv, n_lin) == (53, 1), f"inference: {n_conv} QuantizedConv2D"
          f" and {n_lin} QuantizedLinear, not 53 and 1")
    fc = qnet.fc
    K, N = fc.qweight.shape
    check(batch > 16 and K % 8 == 0 and N % 8 == 0 or not on_card,
          f"inference: the fc ({batch} x {K} x {N}) is off _int_mm's route")
    with paddle.no_grad():
        want_q = qnet(paddle.to_tensor(x)).numpy()
        want_f = net(paddle.to_tensor(x)).numpy()

    # -- jit.save both and serve both
    with tempfile.TemporaryDirectory(prefix="infer_smoke_",
                                     dir=os.getcwd()) as tmp:
        prefix = {n: os.path.join(tmp, n) for n in ("int8", "f32")}
        save_s = {}
        for name, model in (("int8", qnet), ("f32", net)):
            t0 = time.perf_counter()
            paddle.jit.save(model, prefix[name],
                            input_spec=[InputSpec(list(shape), "float32")])
            save_s[name] = time.perf_counter() - t0
        size = {n: os.path.getsize(p + ".pdiparams")
                for n, p in prefix.items()}
        saved_int8 = _saved_state(prefix["int8"] + ".pdiparams")
        f32_4d = [k for k, v in saved_int8.items()
                  if v.dtype == torch.float32 and v.dim() == 4]
        check(size["int8"] < 0.5 * size["f32"] and not f32_4d,
              f"inference: int8 payload {size['int8']} B vs f32 "
              f"{size['f32']} B; float32 conv weights {f32_4d[:3]}")

        def config(p):
            c = inference.Config(p + ".pdmodel")
            if not on_card:
                c.disable_gpu()
            return c
        t0 = time.perf_counter()
        preds = {n: inference.create_predictor(config(p))
                 for n, p in prefix.items()}
        create_s = time.perf_counter() - t0
        served = {n: p.run([x])[0] for n, p in preds.items()}
        check(np.array_equal(served["int8"], want_q), "inference: the int8 "
              "Predictor's logits differ from the quantized eager model's")
        check(np.array_equal(served["f32"], want_f), "inference: the f32 "
              "Predictor's logits differ from the eager model's")
        ms = {n: [] for n in preds}
        for _ in range(INFER_TURNS):
            for n, p in preds.items():
                _sync(torch, dev)
                t0 = time.perf_counter()
                p.run([x])
                ms[n].append(1e3 * (time.perf_counter() - t0))
        ref = served["f32"]
        scale = float(np.abs(ref).max())
        rel_q = float(np.abs(served["int8"] - ref).max() / scale)
        top1 = float(np.mean(served["int8"].argmax(1) == ref.argmax(1)))
        check(np.isfinite(served["int8"]).all() and rel_q <= INFER_REL_MAX
              and top1 >= INFER_TOP1_MIN, f"inference: int8 logits off "
              f"the f32 ones by {rel_q} (max {INFER_REL_MAX}), top-1 "
              f"agreement {top1} (min {INFER_TOP1_MIN})")
        del preds

        # -- convert_to_mixed_precision of the f32 artifact
        conv = {}
        for prec in ("bfloat16", "int8"):
            dst = os.path.join(tmp, f"f32_{prec}")
            t0 = time.perf_counter()
            inference.convert_to_mixed_precision(prefix["f32"], dst, prec,
                                                 device=dev)
            c_s = time.perf_counter() - t0
            ratio = os.path.getsize(dst + ".pdiparams") / size["f32"]
            got = inference.create_predictor(config(dst)).run([x])[0]
            rel = float(np.abs(got - ref).max() / scale)
            check(ratio <= CONVERT_RATIO_MAX[prec] and
                  rel <= CONVERT_REL_MAX[prec], f"convert ({prec}): payload "
                  f"ratio {ratio:.3f} (max {CONVERT_RATIO_MAX[prec]}), "
                  f"logits rel {rel:.4f} (max {CONVERT_REL_MAX[prec]})")
            conv[prec] = dict(payload_ratio=ratio, logits_rel=rel,
                              top1_agreement=float(np.mean(
                                  got.argmax(1) == ref.argmax(1))),
                              convert_s=c_s)

    # -- the int32 accumulator on every route
    routes = []
    if on_card:
        g = torch.Generator().manual_seed(0)
        for M, Kr, Nr in INT8_ROUTE_SHAPES:
            xq = torch.randint(-127, 128, (M, Kr), generator=g,
                               dtype=torch.int8)
            w = torch.randint(-127, 128, (Kr, Nr), generator=g,
                              dtype=torch.int8)
            want = xq.int() @ w.int()
            card_acc = int8_product(xq.to(dev), w.to(dev)).cpu()
            f64 = (xq.to(dev).double() @ w.to(dev).double()).to(
                torch.int32).cpu()
            rule = M > 16 and Kr % 8 == 0 and Nr % 8 == 0
            check(torch.equal(card_acc, want) and torch.equal(f64, want),
                  f"QuantizedLinear ({M}, {Kr}, {Nr}): the int32 "
                  f"accumulators differ across routes")
            routes.append(dict(M=M, K=Kr, N=Nr,
                               route="_int_mm" if rule else "float64"))

    n_img = batch
    out.update(
        quantized=dict(conv2d=n_conv, linear=n_lin,
                       fc=dict(M=batch, K=int(K), N=int(N))),
        calibration_s=observe_s + convert_s, observe_s=observe_s,
        freeze_s=convert_s, save_s=save_s, pdiparams_bytes=size,
        payload_ratio=size["int8"] / size["f32"], create_s=create_s,
        int8_logits_bit_equal=True, f32_logits_bit_equal=True,
        int8_rel_to_f32=rel_q, int8_top1_agreement=top1,
        served_ms={n: float(np.median(v)) for n, v in ms.items()},
        served_ms_each=ms,
        images_per_s={n: n_img / float(np.median(v)) * 1e3
                      for n, v in ms.items()},
        convert=conv, int32_routes=routes,
        seconds=state["seconds"] + time.perf_counter() - t_part2)
    del net, qnet
    if on_card:
        gc_cuda(torch)
    print(f"inference [{card}]: {json.dumps(out)}")
    print(f"inference [{card}]: ResNet-50 B {batch} PTQ int8 (53 + 1 "
          f"layers): calibration {out['calibration_s']:.2f} s (observe "
          f"{observe_s:.2f}, freeze {convert_s:.2f}), served "
          f"{out['served_ms']['int8']:.2f} ms a batch int8 vs "
          f"{out['served_ms']['f32']:.2f} f32, payload "
          f"{out['payload_ratio']:.3f}x, rel {rel_q:.4f}, top-1 {top1:.3f};"
          f" {out['seconds']:.1f} s")
    return out


def load_parent(root):
    """``root``/paddle_tpu_torch imported as ``parent_paddle_tpu_torch``:
    the package imports itself only relatively, so its kernels build from
    its own sources into its own ``build/``."""
    import importlib
    import importlib.util
    pkg = os.path.join(root, "paddle_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_paddle_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    mods = {n: importlib.import_module(f"{spec.name}.{n}")
            for n in ("bench", "ops._build", "ops.fused_blocks",
                      "ops.flash_attention", "models.llama")}
    mods["paddle"] = mod
    return mods


EAGER_TURN_STEPS = 4    # eager_turn's steps; the first is the warm-up


def eager_turn(torch, paddle, tllama, tbench):
    """One package's eager ``LlamaForCausalLM`` at bench.py's shape
    (``eager_phase``'s model and optimizer) for ``EAGER_TURN_STEPS``
    steps: (the mean step ms of steps 2 on, the launches a step)."""
    dev = torch.device("cuda")
    gc_cuda(torch)
    paddle.set_device("gpu")
    paddle.seed(0)
    cfg = tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
    net = tllama.LlamaForCausalLM(cfg)
    sched = paddle.optimizer.lr.LinearWarmup(EAGER_LR, 2, EAGER_LR / 10,
                                             EAGER_LR)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    batch = tbench.make_batch(cfg, 4, tbench.SEQ, dev)
    ids = paddle.to_tensor(batch["input_ids"])
    labels = paddle.to_tensor(batch["labels"])
    kernels = dict(tbench.KERNELS)
    _zero(kernels)
    ms = []
    for _ in range(EAGER_TURN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = net(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        del loss
    launches = {n: c / EAGER_TURN_STEPS
                for n, c in _counts(kernels).items()}
    del net, opt
    gc_cuda(torch)
    return float(np.mean(ms[1:])), launches


TURNS = ("parent", "change", "change", "parent")


def compare_turns(torch, parent_root, smi):
    """The parent's package against this tree's in turns P C C P, every
    kernel timed by graph replay on the same inputs (each package's
    outputs held to its plain version first), each tree's train step
    measured by its own ``bench.measure`` (2 warm-up + 5 steps, fused
    and unfused) and its eager ``LlamaForCausalLM`` step
    (``eager_turn``); the launches a step must be the same in every
    turn.  Prints one line a turn and, last, the turns as JSON."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.ops import fused_blocks
    import paddle_tpu_torch
    from paddle_tpu_torch.models import llama
    pkgs = {"change": {"bench": bench, "ops._build": _build,
                       "ops.fused_blocks": fused_blocks,
                       "ops.flash_attention": flash_attention,
                       "models.llama": llama, "paddle": paddle_tpu_torch},
            "parent": load_parent(parent_root)}
    for name, mods in pkgs.items():
        t0 = time.perf_counter()
        mods["ops._build"].build_all()
        print(f"compare: {name}'s kernels built in "
              f"{time.perf_counter() - t0:.1f} s")
    B, S, H, D, I = FUSED_SHAPE
    t = fused_inputs(torch, B, S, H, D, I)
    fl = {}
    for d in (128, 64):     # flash_timing's shapes
        q, k, v, do = flash_inputs(torch, *FLASH_CASES[-1][:3], d)
        fl[d] = (q, k, v, do, *pkgs["change"]["ops.flash_attention"]
                 .flash_fwd(q, k, v))
    turns = []
    for turn in TURNS:
        fb_ = pkgs[turn]["ops.fused_blocks"]
        fa_ = pkgs[turn]["ops.flash_attention"]
        calls = {
            "fused_qkv": lambda: fb_.fused_qkv(
                t["x"], t["ln"], t["wq"], t["wk"], t["wv"], t["sin"],
                t["cos"], head_dim=D, eps=EPS),
            "fused_attn_epilogue": lambda: fb_.fused_attn_epilogue(
                q7, k7, v7, t["x"], t["wo"], head_dim=D),
            "fused_mlp_fwd": lambda: fb_.fused_mlp_fwd(
                t["x"], t["ln"], t["wg"], t["wu"], t["wd"], eps=EPS),
            "fused_mlp_bwd_dx": lambda: fb_.fused_mlp_bwd_dx(
                t["x"], t["ln"], t["wg"], t["wu"], t["wd"], t["dy"],
                eps=EPS),
        }
        q7, k7, v7 = calls["fused_qkv"]()
        ref = fb_._fused_qkv_plain(t["x"], t["ln"], t["wq"], t["wk"],
                                   t["wv"], t["sin"], t["cos"], D, EPS)
        for n, g, r in zip("qkv", (q7, k7, v7), ref):
            e = rms_rel(g, r, True)
            check(e <= ROW_REL_MAX, f"compare {turn}: fused_qkv {n} row rel "
                  f"{e} > {ROW_REL_MAX}")
        del ref
        res = {"turn": turn}
        for n, fn in calls.items():
            res[n] = time_ms(torch, lambda i: fn(), calls=10)
        for d, (q, k, v, do, o, lse) in fl.items():
            res[f"flash_bwd_d{d}"] = time_ms(
                torch, lambda i: fa_.flash_bwd(q, k, v, o, lse, do), calls=20)
        del q7, k7, v7
        tb_ = pkgs[turn]["bench"]
        for mode, fb_mode in (("fused", None), ("unfused", "off")):
            r = tb_.measure(iters=5, warmup=2, fused_blocks=fb_mode)
            check(not r["oom_rungs"], f"compare {turn} {mode}: out of memory")
            res[f"{mode}_step_ms"] = r["step_ms"]
            res[f"{mode}_mfu"] = r["value"]
            res[f"{mode}_launches"] = r["launches_per_step"]
        res["eager_step_ms"], res["eager_launches"] = eager_turn(
            torch, pkgs[turn]["paddle"], pkgs[turn]["models.llama"], tb_)
        turns.append(res)
        print(f"compare turn {turn} [{smi}]: " + "  ".join(
            f"{k} {v:.4f}" for k, v in res.items()
            if isinstance(v, float)))
    for mode in ("fused", "unfused", "eager"):
        ls = [t[f"{mode}_launches"] for t in turns]
        check(all(x == ls[0] for x in ls), f"compare: {mode} launches a "
              f"step differ between the trees: {ls}")
    print(json.dumps({"compare": turns, "gpu": smi}))


def main(argv=()):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time a parent tree's package against this one "
                         "in turns P C C P instead of the smoke run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import paddle_tpu_torch ({exc}); run "
              f"from the repository root", file=sys.stderr)
        return 2
    from paddle_tpu_torch import bench as tbench
    from paddle_tpu_torch import bench_serve, serving
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_blocks as fb
    from paddle_tpu_torch.ops import int8_matmul as i8
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.runtime import watchdog
    from paddle_tpu_torch.testing import chaos

    # the first CUDA call of the run: a refused init is retried here
    device_init_line(watchdog)
    card = torch.cuda.get_device_name(0)
    smi = gpu_line()
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.against:
        compare_turns(torch, args.against, smi)
        return 0

    t_run = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_run:.1f} s] {what} done")

    # What runs side by side is started here, in main, and nowhere
    # else: nvcc's processes through _build, every other process through
    # beside().  While the kernels compile (one nvcc a source, started
    # together), serving an exported model begins, which needs none of
    # them (ResNet-50, cuDNN convolutions, torch._int_mm): the example's
    # process, and PTQ's observation and freeze in this one.
    started = _build.start_all(ptxas_verbose=True)
    (example,) = beside(functools.partial(quantize_serve_example, card))
    calibrated = inference_calibrate(torch, card)
    report = _build.finish_all(started)
    example.result()
    print("kernels built (from the start of the run): "
          + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))
    for n, r in report.items():
        for fn, use in _build.ptxas_usage(r["log"]).items():
            print(f"  {n}: {fn}: {use['registers']} registers, "
                  f"{use['smem_bytes']} bytes smem; {use['spill']}")

    # the gang runtime: a 2-rank pod uninterrupted, beside it the bench's
    # gang preset and the in-process resize's pod; then, alone, the pod
    # killed and relaunched, and the resize's world-size-1 reference
    clean, _, resized = (f.result() for f in beside(
        gang_clean_job(torch), functools.partial(gang_bench_line, card),
        resize_pod))
    gang = gang_phase(torch, card, clean)
    resize = resize_phase(torch, tbench, tllama, dist, card, resized)
    stamp("builds, calibration, gang, resize")
    # serving an exported model: the int8 ResNet-50 saved and served
    # through the Predictor beside float32 and the converted artifacts
    infer = inference_phase(torch, card, calibrated)
    del calibrated
    stamp("inference")
    # checkpoints, health, the launcher: a small model's corruption
    # fallback and crashed commit, bench.py's shape saved, restored and
    # resumed at world size 1
    small_ckpt_check(torch, tllama, dist)
    ckpt = ckpt_phase(torch, tbench, tllama, dist, card,
                      model=big_model(tbench))
    stamp("checkpoints")
    # the training loop around the step: the data pipeline, the rewind,
    # the Profiler with xmem and numerics, localize; then the in-process
    # resize of a 2-rank plan to 1
    loop = train_loop_phase(torch, tbench, tllama, dist, card, report,
                            model=big_model(tbench))
    stamp("train loop")

    int8_rows, int8_err = int8_phase(torch, i8)
    int8_regimes = int8_plans(torch, i8)
    rpa_rows, rpa_err = rpa_phase(torch, rpa)
    quant_rows, quant_err = rpa_phase(torch, rpa, quant=True)
    flash, flash_err, flash_row_err, flash_ctl = flash_phase(torch, fa)
    fused = fused_phase(torch, fb)
    small_reference_check(torch, tllama, convert, rpa)
    small_spec_check(torch, tllama, serving, chaos)
    small_router_check(torch, tllama, serving, chaos)
    stamp("kernel phases, small checks")
    # the serving path: llama7b (32 layers, int8 weights) on the card,
    # bf16 KV, int8 KV, int8 KV + shared prefix with and without
    # speculation; then crash recovery on the same weights
    serve, params = serve_phase(torch, tllama, bench_serve, card)
    recovery = recovery_phase(torch, tllama, serving, chaos, watchdog,
                              bench_serve, params, card)
    print(f"recovery [{card}]: {json.dumps(recovery)}")
    # the serving stack on the same weights: two replicas behind a router
    # (clean, kill, drain, hang), then what observability costs
    fleet = fleet_phase(torch, tllama, bench_serve, params, card)
    print(f"fleet [{card}]: {json.dumps(fleet)}")
    extra = (fleet["clean"]["max_memory_allocated"]
             - serve["int8"]["max_memory_allocated"])
    print(f"fleet [{card}]: the clean run's peak memory over the int8 serve "
          f"run's: {extra} bytes (one replica's KV pools: "
          f"{fleet['clean']['pool_bytes']})")
    obs_cost = obs_cost_phase(torch, bench_serve, params, card)
    print(f"obs cost [{card}]: {json.dumps(obs_cost)}")
    stamp("serve, recovery, fleet, obs cost")
    # the model families' front ends: GPT-2 small, llama7b's generate over
    # the serve weights, LlamaForCausalLM, ERNIE-base pretraining
    models = models_phase(torch, tllama, i8, fa, fb, dist, params, serve,
                          card, tbench)
    del params
    stamp("models")
    launches = serve["bf16"]["launches"]
    by_run = {n: r["launches"] for n, r in serve.items()}
    by_run.update({f"fleet_{n}": r["launches"] for n, r in fleet.items()})
    for mode in ("on", "off"):
        small_train_check(torch, tllama, mode)
    small_moe_check(torch, tllama, serving)
    # the train path: bench.py's ~0.95B model, S = 2048, on the card, at
    # the default policy (the fused blocks), then unfused (the yardstick,
    # and the path that runs flash_fwd)
    fused_launches, fused_res = train_phase(torch, tbench, card)
    train_launches, unfused_res = train_phase(torch, tbench, card, "off")
    print(f"train [{card}]: fused step {fused_res['step_ms']:.2f} ms "
          f"(MFU {fused_res['value']:.2f} %), unfused step "
          f"{unfused_res['step_ms']:.2f} ms (MFU {unfused_res['value']:.2f} "
          f"%), same call")
    ledger_phase(fused_res, serve["bf16"], card)
    train_profile(torch, tbench, tllama, card)
    train_profile(torch, tbench, tllama, card, "off")
    stamp("train, ledger, train profiles")
    # the eager core: the op sweep on the card, bench.py's Llama and
    # GPT-2 small trained the Paddle way
    eager = eager_phase(torch, tbench, tllama, fa, fb, card, fused_res)
    stamp("eager")
    # the vision stack: LeNet's example (and its resume) and ResNet-50
    # through Model.fit at its published width
    vision = vision_phase(torch, card)
    stamp("vision")
    # mixed precision and the sequence layers: bench.py's Llama under
    # AMP O2 with master weights and a GradScaler; Transformer-base under
    # O1 and fp16 with dynamic scaling, ERNIE-base's width through the
    # incubate fused encoder, an LSTM beam search, LBFGS
    amp = amp_phase(torch, tbench, tllama, card, fused_res, eager)
    seq = seq_phase(torch, card)
    stamp("amp, seq")
    # jit / static / asp / the eager MoE layer: bench.py's Llama through
    # to_static, jit.save and a fresh process's jit.load, the static
    # Executor's train step, asp's 2:4 pruning; MoELayer at llama1b's width
    jst = jit_static_phase(torch, tbench, tllama, card, eager)
    sl = jst["save_load"]
    jit_launches = {n: dict(
        to_static_forward=jst["to_static"]["replay_launches"][n],
        jit_load_forward=sl["fused"]["launches"][n],
        jit_load_unfused_forward=sl["unfused"]["launches"][n],
        predictor_forward=sl["fused"]["predictor"]["launches"][n],
        predictor_unfused_forward=sl["unfused"]["predictor"]["launches"][n],
        capi_host_forward=sl["capi_host"]["launches"][n] // CAPI_RUNS,
        static_steps=jst["static"]["launches"][n]) for n in tbench.KERNELS}
    stamp("jit, static, asp, moe layer, predictor, C host")
    # the distributed train step: bench.py's shape at world size 1 over
    # NCCL (in turns with bench.train_step), then as 2 ranks (mp=2, dp=2
    # + ZeRO-1) over gloo, beside which a small model's topologies run as
    # 4 ranks (and its sp=2 as 2) against its world size 1, run here
    ws1 = dist_ws1_phase(torch, tbench, tllama, dist, card)
    # beside them, the eager distributed API's world (fleet at dp=2, mp=2
    # layers, ERNIE at pp=2); its world-size-1 references run here.  Its
    # files' directory goes below, or at exit whatever happens
    api_tmp = tempfile.TemporaryDirectory(prefix=API_FILES, dir=".")
    api_dir = api_tmp.name
    t_api = time.perf_counter()
    *big, four, two, api = beside(*dist_big_jobs(dist),
                                  *small_world_jobs(dist),
                                  dist_api_job(dist, api_dir))
    worlds = small_worlds(four, two)
    api_refs = dist_api_refs(torch, tbench, tllama, api_dir)
    dist_res = dist_train_phase(
        torch, tbench, tllama, card, ws1,
        {name: f.result() for (name, _), f in zip(DIST_BIG, big)})
    small_dist_check(torch, dist, worlds)
    api_res = dist_api_phase(torch, tbench, card, api.result(), api_refs,
                             eager, api_dir, time.perf_counter() - t_api)
    api_tmp.cleanup()
    del api_refs
    gc_cuda(torch)
    api_launches = {n: dict(
        plain_micro_step=api_res["llama"]["launches_plain"][n],
        recompute_micro_step=api_res["llama"]["launches_recompute"][n])
        for n in tbench.KERNELS}
    dist_launches = {
        n: dict(ws1_per_step=dist_res["turns"][1]["launches_per_step"][n],
                **{f"{b}_rank0": dist_res["big"][b]["ranks"][0]["launches"][n]
                   for b in dist_res["big"]})
        for n in tbench.KERNELS}
    stamp("dist train, dist api")
    # the pipeline and context parallelism: a small model's schedules and
    # sp against world size 1, then bench.py's shape at pp=2 under every
    # schedule and at sp=2 (2 ranks over gloo each), then the bench's
    # --multichip line
    small_pp_check(torch, dist, worlds)
    # the sp=2 world runs beside the pp=2 one
    (cp_ranks,) = beside(cp_job(dist))
    pp_res = pipeline_phase(torch, tbench, tllama, dist, card)
    cp_res = cp_phase(torch, tbench, tllama, card,
                      dist_res["ws1_big"]["losses"],
                      dist_res["ws1_big"]["peak_over_base"],
                      cp_ranks.result())
    multichip_line(card)
    stamp("pipeline, cp, multichip")
    # the MoE layer: bench.py's shape with 8 experts at world size 1, as 2
    # ranks at dp=2 (4 experts a rank), and served
    check(moe_reckoning(moe_cfg(tllama))[:2] == (4_728_358_912,
                                                 4_328_521_728),
          "moe: the model's parameters are not the reckoned 4.73e9")
    moe_train = moe_train_phase(torch, tbench, tllama, dist, card)
    moe_dist = moe_dist_phase(torch, tllama, dist, card, moe_train)
    moe_serve = moe_serve_phase(torch, tllama, serving, bench_serve, card)
    stamp("moe")
    moe_launches = {n: dict(ws1_per_step=moe_train["launches_per_step"][n],
                            dp2_rank0=moe_dist["ranks"][0]["launches"][n])
                    for n in tbench.KERNELS}
    # a rank's launches over the 2 steps of each schedule / of sp=2
    pp_launches = {n: {s: pp_res["ranks"][0]["runs"][s]["launches"][n]
                       for s, _ in PP_BIG_CASES} for n in tbench.KERNELS}
    sp_launches = {n: cp_res["ranks"][0]["runs"]["sp2"]["launches"][n]
                   for n in tbench.KERNELS}

    # one step of the main path: 225 int8 matmuls at M = 8 (decode), 64
    # (the default cell's prefill), 512 (the long-context prefill) and
    # 1024 (generate's prefill), and 32 attention calls at the decode case
    step, pre64, pre512, pre1024 = (int8_step(int8_rows, M)
                                    for M in INT8_ROWS)
    step_keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
    att = next(r for r in rpa_rows if r["name"] == "decode_tc1")
    long = {n: next(r for r in rows if r["name"] == "decode_long")
            for n, rows in (("dense", rpa_rows), ("quant", quant_rows))}
    qdec = next(r for r in quant_rows if r["name"] == "decode_tc1")
    _, att_by = bound_ms(att["bytes"], att["ops"], "bf16")
    long_keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "bytes", "row_rel_err", "norm_rel_err",
                 "control_row_rel_err")
    case_keys = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "S", "tile_rows", "max_abs_err",
                 "row_rel_err")
    cases = {n: {r["name"]: {k: r[k] for k in case_keys} for r in rows}
             for n, rows in (("dense", rpa_rows), ("quant", quant_rows))}
    kernels = {"kernels": [
        {"name": "int8_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/int8_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas_ops.py:2276",
         "launches": launches["int8_matmul"],
         "max_abs_err": int8_err, "ms": step["ms"],
         "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
         "bound_by": step["bound_by"], "library_ms": step["library_ms"],
         "eager_ms": step["eager_ms"],
         "per": "one llama7b decode step: 225 calls at M=8",
         "prefill_step": {k: pre512[k] for k in step_keys},
         "prefill_per": "one long-context prefill step: 225 calls at M=512",
         "default_prefill_step": {k: pre64[k] for k in step_keys},
         "default_prefill_per": "one default-cell prefill step: 225 calls "
                                "at M=64",
         "generate_prefill_step": {k: pre1024[k] for k in step_keys},
         "generate_prefill_per": "llama7b generate's prefill: 225 calls at "
                                 "M=1024 (B 8 x a 128-token prompt)",
         "library": "the faster of torch._int_mm on row-major and "
                    "K-contiguous weights, + the epilogue",
         "calls": [{k: r[k] for k in ("M", "K", "N", "ms", "bound_ms",
                                      "plain_ms", "library_ms")}
                   for r in int8_rows],
         "regimes": int8_regimes,
         "launches_by_run": {n: v["int8_matmul"] for n, v in by_run.items()},
         "launches_moe_serve": {n: moe_serve[n]["launches"]["int8_matmul"]
                                for n, _ in MOE_SERVE_RUNS},
         "launches_generate": models["llama_generate"]["launches"],
         "launches_generate_per": "llama7b generate over int8 weights: "
                                  "the prefill + 31 decode steps, 225 "
                                  "each"},
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas_ops.py:1781",
         "launches": launches["ragged_paged_attention"],
         "max_abs_err": rpa_err, "ms": 32 * att["ms"],
         "plain_ms": 32 * att["plain_ms"], "bound_ms": 32 * att["bound_ms"],
         "bound_by": att_by, "library_ms": 32 * att["library_ms"],
         "eager_ms": 32 * att["eager_ms"],
         "per": "one llama7b decode step: 32 calls, R=8, Tc=1, page 16",
         "long_decode": {k: long["dense"][k] for k in long_keys},
         "long_per": "one call, R=8 x 2048 tokens, 32 kv heads of 128, "
                     "page 16",
         "cases": cases["dense"],
         "launches_by_run": {n: v["ragged_paged_attention"]
                             for n, v in by_run.items()},
         "launches_moe_serve": {n: moe_serve[n]["launches"][
             "ragged_paged_attention"] for n, _ in MOE_SERVE_RUNS}},
        {"name": "ragged_paged_attention_quant", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas_ops.py:1841",
         "launches": serve["int8"]["launches"][
             "ragged_paged_attention_quant"],
         "max_abs_err": quant_err,
         **{k: long["quant"][k] for k in long_keys},
         "row_rel_max": ROW_REL_MAX, "norm_rel_max": NORM_REL_MAX,
         "per": "one call, R=8 x 2048 tokens, 32 kv heads of 128, page 16, "
                "int8 pages + f32 scales (the long decode case)",
         "decode_step": {k: 32 * qdec[k] for k in
                         ("ms", "plain_ms", "bound_ms", "library_ms")},
         "cases": cases["quant"],
         "launches_by_run": {n: v["ragged_paged_attention_quant"]
                             for n, v in by_run.items()},
         "launches_moe_serve": {n: moe_serve[n]["launches"][
             "ragged_paged_attention_quant"] for n, _ in MOE_SERVE_RUNS}},
    ]}
    # the flash wrappers, per call at the bench shape; each replaces a
    # resident body and its streamed twin (one TPU VMEM-capacity split),
    # and flash_bwd the dq and dk/dv bodies both
    per = "one call at B=4 S=2048 H=16 D=128 (the bench step's shape)"
    src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    f128, f64 = flash[128], flash[64]

    def at(f, key):
        return {k: (f[k][key] if k != "bounds" else f[k][key][0])
                for k in ("ms", "plain_ms", "library_ms", "bounds")}

    gpt = models["gpt"]
    for name, key, lines, extra in (
            ("flash_fwd", "fwd", (543, 313), dict(d64=at(f64, "fwd"))),
            ("flash_bwd", "bwd", (609, 645, 398, 439), dict(
                launches_per="3 kernels a call: delta pre-pass, main, cast",
                kernel_ms=f128["profile"], d64=at(f64, "bwd")))):
        extra.update(
            gpt2=at(flash["gpt2"], key),
            gpt2_per="one call at B=8 S=1024 H=12 D=64 (GPT-2 small)",
            launches_gpt=dict(step=gpt["launches_per_step"][name],
                              step_remat=gpt["launches_per_step_remat"][
                                  name]))
        kernels["kernels"].append(dict(
            name=name, route="cuda", source=src,
            replaces=f"paddle_tpu/ops/pallas_ops.py:{lines[0]}",
            also_replaces=[f"paddle_tpu/ops/pallas_ops.py:{n}"
                           for n in lines[1:]],
            launches=train_launches[name],
            launches_fused_step=fused_launches[name],
            launches_dist=dist_launches[name],
            launches_pp=pp_launches[name], launches_sp=sp_launches[name],
            launches_moe=moe_launches[name],
            launches_ckpt=ckpt["launches"][name],
            launches_gang_rank0=gang["launches_rank0_clean"][name],
            launches_train_loop=loop["launches"][name],
            launches_resize_rank0=resize["launches_rank0"][name],
            launches_eager=eager["llama"]["launches"][name],
            launches_eager_gpt=eager["gpt"]["launches"][name],
            launches_amp=amp["launches"][name],
            launches_jit_static=jit_launches[name],
            launches_dist_api=api_launches[name],
            max_abs_err=flash_err[key],
            row_rel_err=flash_row_err[key], row_rel_max=ROW_REL_MAX,
            control_row_rel_err=min(
                flash_ctl[n] for n in {"fwd": ("o",),
                                       "bwd": ("dq", "dk", "dv")}[key]),
            ms=f128["ms"][key], plain_ms=f128["plain_ms"][key],
            bound_ms=f128["bounds"][key][0],
            bound_by=f128["bounds"][key][1],
            library_ms=f128["library_ms"][key], per=per, **extra))
    # the fused blocks, per call at the bench shape; no one PyTorch call
    # computes any of them, so the unfused composition stands beside
    per = "one call at B=4 S=2048 H=2048 D=128 I=5632 (the bench step's)"
    src = "paddle_tpu_torch/ops/csrc/fused_blocks.cu"
    for name, line, note in (
            ("fused_qkv", 1130,
             "row pass (xn) + one wgmma GEMM launch over q, k, v (grid z = "
             "3), rope on q and k from registers"),
            ("fused_attn_epilogue", 1200,
             "two launches: flash_fwd's kernel (attn, lse), then the GEMM "
             "y = x + attn wo"),
            ("fused_mlp_fwd", 1417,
             "row pass + wgmma GEMM [g | u] (dual B) with silu*mul epilogue "
             "+ wgmma GEMM a wd + x"),
            ("fused_mlp_bwd_dx", 1444,
             "row pass + one wgmma launch for dy wd^T and [g | u] with dg, "
             "du epilogue + wgmma GEMM [dg | du] [wg | wu]^T (K-major B, K "
             "split) + RMSNorm-backward row pass")):
        r = fused[name]
        kernels["kernels"].append(dict(
            name=name, route="cuda",
            source=src if name != "fused_attn_epilogue"
            else f"{src} + paddle_tpu_torch/ops/csrc/flash_attention.cu",
            replaces=f"paddle_tpu/ops/pallas_ops.py:{line}",
            launches=fused_launches[name], max_abs_err=r["max_abs_err"],
            launches_dist=dist_launches[name],
            launches_pp=pp_launches[name], launches_sp=sp_launches[name],
            launches_moe=moe_launches[name],
            launches_ckpt=ckpt["launches"][name],
            launches_gang_rank0=gang["launches_rank0_clean"][name],
            launches_train_loop=loop["launches"][name],
            launches_resize_rank0=resize["launches_rank0"][name],
            launches_eager=eager["llama"]["launches"][name],
            launches_amp=amp["launches"][name],
            launches_jit_static=jit_launches[name],
            launches_dist_api=api_launches[name],
            row_rel_err=r["row_rel_err"], row_rel_max=ROW_REL_MAX,
            norm_rel_err=r["norm_rel_err"],
            control_row_rel_err=r["control_row_rel_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            composition_ms=r["composition_ms"], kernel_ms=r["kernel_ms"],
            per=per, launches_per=note,
            **({"launches_facade": models["facade"]["launches"][name]}
               if name in models["facade"]["launches"] else {})))
    check(len(kernels["kernels"]) == 9, "the kernels line lists "
          f"{len(kernels['kernels'])} kernels, not 9")
    print(f"moe [{card}]: train {json.dumps(moe_train)}; dist "
          f"{json.dumps(moe_dist)}; serve {json.dumps(moe_serve)}")
    print(f"models [{card}]: {json.dumps(models)}")
    print(f"eager_ops {eager['ops']['passed']}/{eager['ops']['total']}")
    print(f"vision [{card}]: {json.dumps(vision)}")
    print(f"inference [{card}]: int8 served {infer['served_ms']['int8']:.2f}"
          f" ms a batch, f32 {infer['served_ms']['f32']:.2f} ms; Predictor "
          f"(Llama, fused) {sl['fused']['predictor']['run_ms']:.2f} ms, C "
          f"host {sl['capi_host']['run_ms']:.2f} ms")
    print(f"amp [{card}]: step {amp['step_ms']:.2f} ms, optimizer.step() "
          f"{amp['optimizer_step_ms']:.2f} ms, peak {amp['peak_over_base']}"
          f" B; seq: Transformer-base O1 "
          f"{seq['transformer_o1']['step_ms']:.2f} ms, fused encoder "
          f"{seq['fused_encoder']['step_ms']:.2f} ms, beam step "
          f"{seq['lstm_beam']['decode_step_ms']:.3f} ms")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--gang-worker" in sys.argv[1:]:
        sys.exit(gang_worker(sys.argv[1:]))
    if "--resize-worker" in sys.argv[1:]:
        sys.exit(resize_worker(sys.argv[1:]))
    sys.exit(main(sys.argv[1:]))
