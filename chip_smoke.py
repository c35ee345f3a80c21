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
  ``dist_train_phase``);
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
  Several ranks on the one card run over gloo, whose point-to-point
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
import json
import math
import os
import re
import subprocess
import sys
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
# prefill chunk (8 x 8) and the long-context cell's (8 x 64)
INT8_ROWS = (8, 64, 512)


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


OBS_TURNS = (False, True, True, False, False, True, True, False)


def obs_cost_phase(torch, bench_serve, params, card):
    """What metrics and the flight recorder cost a user of the card: the
    bench's bf16-KV serve run at llama7b with ``FLAGS_tpu_metrics`` and
    ``FLAGS_tpu_trace`` off and on, in turns off, on, on, off twice in
    one call after one discarded warm-up run (medians a side), and the
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
# the bench shape last
FLASH_CASES = [(1, 1, 2, 128), (2, 17, 3, 64), (1, 200, 2, 128),
               (1, 257, 2, 64), (1, 1000, 2, 128), (1, 4096, 4, 64),
               (4, 2048, 16, 128)]


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
    backward must give the same bits; timed there and at D = 64."""
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
    for D in (128, 64):     # the bench shape, then its head dim halved
        B, S, H = FLASH_CASES[-1][:3]
        q, k, v, do = flash_inputs(torch, B, S, H, D)
        o, lse = fa.flash_fwd(q, k, v)
        timing[D] = flash_timing(torch, F, fa, q, k, v, do, o, lse)
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


def profile_classes(prof, head, class_flops, kernel_flops):
    """Every device row summed into ``PROFILE_CLASSES`` ("other" printed
    with its largest names), each with its share of the busy time and,
    where ``class_flops`` gives its products, TFLOP/s; the port's GEMM
    kernels one by one with ``kernel_flops`` (FLOPs a launch).  Fails
    unless the classes sum to the trace's busy time within 0.5 %."""
    rows = device_rows(prof)
    busy = busy_union_us(prof)
    names = [n for n, _ in PROFILE_CLASSES] + ["other"]
    sums = {n: [0.0, 0, []] for n in names}
    for e in rows:
        cls = next((n for n, pat in PROFILE_CLASSES if re.search(pat, e.key)),
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
DIST_SMALL_SHAPE = (4, 128, 3)          # global batch, sequence, steps
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


def small_dist_check(torch, dist, device="cuda"):
    """The distributed step of a small bf16 model as 4 ranks on the one
    card over gloo (NCCL takes one rank a card): dp=2 x mp=2, dp=2 x
    sharding=2 (ZeRO over sharding) and dp=4 with the overlapped
    reduction, 3 steps each, held to the same model's world-size-1 step
    on the card (losses within ``DIST_LOSS_ATOL``, params by
    ``dist_param_check``); the ranks of one replica set hold the same
    bits."""
    t0 = time.perf_counter()
    ref = dist_small_rank(device, [("ws1", {}, {})])[0]
    ranks = dist.spawn(dist_small_rank, 4, (device, DIST_SMALL_CASES),
                       device=device, backend="gloo", timeout=300)
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
    print(f"small dist check ({time.perf_counter() - t0:.1f} s, 4 ranks "
          f"over gloo on one card, bf16): world size 1 losses "
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
    cfg = tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
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


# each side runs first in half the pairs
DIST_TURNS = ("bench", "dist", "dist", "bench", "dist", "bench", "bench",
              "dist")
DIST_BIG = (("mp2", dict(mp=2)), ("dp2_zero", dict(dp=2)))


def dist_train_phase(torch, tbench, tllama, dist, card):
    """The distributed train step at bench.py's ~0.95B shape (S = 2048,
    B = 4, bf16, "dots", the fused blocks by the default policy).

    World size 1 through ``Plan().train_step`` over an NCCL process
    group, in turns with ``bench.train_step`` (``DIST_TURNS``, 2 warmup
    + 5 timed steps a turn): step ms, MFU, peak memory and
    kernel launches a step, which must equal the bench step's, and the
    losses, which must be the same bits (the same code runs).  Then
    mp=2 and dp=2 with ZeRO-1, each as 2 ranks on the card over gloo
    (host-staged collectives: their times are no throughput), 2 steps:
    per-rank peak memory, weight and optimizer-state bytes against the
    reckoning (weights / mp; AdamW states / 2), losses against world
    size 1 within ``DIST_LOSS_ATOL``, every train kernel launched."""
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
    ref = bench_t[0]
    W, S1 = ref["weight_bytes"], ref["state_bytes"]
    cfg = tllama.LlamaConfig(**tbench.MODEL)
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    norms = (2 * L + 1) * H * 2            # ln1, ln2, norm_f in bf16
    reckon = {"mp2": dict(weight_bytes=(W - norms) // 2 + norms),
              "dp2_zero": dict(weight_bytes=W)}
    reckon["mp2"]["state_bytes"] = 2 * reckon["mp2"]["weight_bytes"]
    reckon["dp2_zero"]["state_bytes"] = S1 // 2
    gc_cuda(torch)
    big = {}
    for name, topo_kw in DIST_BIG:
        ranks = dist.spawn(dist_big_rank, 2, (topo_kw, 2), device="cuda",
                           backend="gloo", timeout=600)
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
        big[name] = dict(
            ranks=[{k: r[k] for k in ("coords", "losses", "step_ms",
                                      "init_max_memory_allocated",
                                      "max_memory_allocated",
                                      "weight_bytes", "state_bytes",
                                      "launches")} for r in ranks],
            reckoned=reckon[name])
    for n in ("fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
              "fused_mlp_bwd_dx", "flash_bwd"):
        check(ws1_launches[n] > 0, f"world size 1: {n} never launched")
    out = dict(turns=turns, ws1_launches=ws1_launches, big=big,
               seconds=time.perf_counter() - t0)
    print(f"dist train [{card}]: {json.dumps(out)}")
    print(f"dist train [{card}]: world size 1 step ms "
          f"{[round(t['step_ms'], 2) for t in turns]} in turns {DIST_TURNS}"
          f" (MFU {[round(t['mfu'], 2) for t in turns]} %), peaks over "
          f"what the process held {[t['peak_over_base'] for t in turns]}; "
          f"per-rank peaks "
          + ", ".join(f"{n} {[r['max_memory_allocated'] for r in b['ranks']]}"
                      for n, b in big.items()))
    return out


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


def small_pp_check(torch, dist, device="cuda"):
    """The pipeline schedules and context parallelism of the small bf16
    model as gloo ranks on the one card (``PP_SMALL_CASES``,
    ``CP_SMALL_CASES``), 3 steps each from the same seed, held to its
    world-size-1 step on the card: losses within ``DIST_LOSS_ATOL``,
    params by ``dist_param_check``; the ranks that hold one block of the
    params (over dp and sp) the same bits, the embedding, norm and head
    the same bits on every stage; 1F1B overlapped the same bits as
    lockstep."""
    t0 = time.perf_counter()
    ref = dist_small_rank(device, [("ws1", {}, {})])[0]
    steps = DIST_SMALL_SHAPE[2]
    worlds = ((4, PP_SMALL_CASES), (2, CP_SMALL_CASES))
    rows = {}
    by_name = {}
    for n, cases in worlds:
        ranks = dist.spawn(dist_small_rank, n, (device, cases),
                           device=device, backend="gloo", timeout=300)
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
    print(f"small pp check ({time.perf_counter() - t0:.1f} s, gloo ranks "
          f"on one card, bf16): world size 1 losses {ref['losses']}; "
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
    cfg = tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
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
    """``bench.train_step`` at bench.py's shape on ``B`` rows (the same
    batch as the ranks'), ``steps`` steps: the losses and the peak over
    what the process held."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tllama.LlamaConfig(remat_policy="dots", **tbench.MODEL)
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
    """Bytes of a pp rank's weights: its L/pp layers and the embedding,
    head and final norm whole."""
    cfg = tllama.LlamaConfig(**tbench.MODEL)
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
    """bench.py's ~0.95B model (S = 2048, bf16, "dots", the fused blocks
    by the default policy) through the pipeline as 2 ranks at pp=2 over
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
    ranks = dist.spawn(big_rank, 2, (dict(pp=2), cases, PP_BIG_BATCH,
                                     BIG_STEPS), device="cuda",
                       backend="gloo", timeout=900)
    rk = pp_reckoning(tllama, tbench, 2)
    weights = rk["layers"] + rk["tail"]
    L_local = tllama.LlamaConfig(**tbench.MODEL).num_hidden_layers // 2
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


def cp_phase(torch, tbench, tllama, dist, card, ws1, ws1_peak):
    """bench.py's shape context parallel: 2 ranks at sp=2 over gloo, B =
    4, 2 steps; ``ws1``/``ws1_peak``: world size 1's losses and peak on
    the same batch (``dist_train_phase``'s bench turn).  Losses within
    ``DIST_LOSS_ATOL``; the fused MLP kernels launched on the rank's
    S/2 rows and the fused attention block not (attention is the
    ring); ``ppermute`` calls and bytes a step equal the code's count:
    2 (k, v) x (sp - 1) x L blocks a forward, again in the remat
    recompute and again, reversed, in the backward."""
    t0 = time.perf_counter()
    ranks = dist.spawn(big_rank, 2, (dict(sp=2), (("sp2", {}),),
                                     CP_BIG_BATCH, BIG_STEPS),
                       device="cuda", backend="gloo", timeout=600)
    cfg = tllama.LlamaConfig(**tbench.MODEL)
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
    ranks = dist.spawn(moe_dist_rank, 2, (MOE_DIST_STEPS, device),
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
# bench.py's shape at full depth, world size 1: 8 steps, a sync save at
# step 2, an async save at step 4 (steps 5-6 run during it), steps 7-8
# with the gang's step-boundary snapshot
CKPT_B, CKPT_STEPS = 4, 8
# the gang phase: bench.py's width at 4 layers (the depth cut keeps the
# script inside its time), Plan(dp=2) as 2 gloo ranks on the card, 2
# rows a rank, 6 steps; the chaos run kills rank 1 at step 3's boundary
GANG_LAYERS, GANG_B, GANG_STEPS = 4, 4, 6
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


def gang_phase(torch, card, device=None, extra_args=()):
    """Two ranks of bench.py's width at ``GANG_LAYERS`` layers on the one
    card over gloo (``Plan(dp=2)``, 2 rows a rank, S = 2048), through
    the launcher: an uninterrupted pod, then a pod whose rank 1 is
    killed (``os._exit``, process-kill mode) at step 3's boundary.  The
    chaos pod must exit 0; the survivor's incident sidecar must hold
    ``health_exit`` (or ``rank_dead``); generation 1 must resume after
    step 3; every step's loss must be bit-identical to the uninterrupted
    pod's.  Detection s (the kill to the survivor's conversion),
    final-save s and bytes, recovery s (the kill to generation 1's first
    finished step), steps lost."""
    import shutil
    t_all = time.perf_counter()
    clean = gang_pod(torch, "clean", None, GANG_STEPS, extra_args, device)
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
        "seconds": time.perf_counter() - t_all,
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
    return {n: importlib.import_module(f"{spec.name}.{n}")
            for n in ("bench", "ops._build", "ops.fused_blocks",
                      "ops.flash_attention")}


TURNS = ("parent", "change", "change", "parent")


def compare_turns(torch, parent_root, smi):
    """The parent's package against this tree's in turns P C C P, every
    kernel timed by graph replay on the same inputs (each package's
    outputs held to its plain version first) and each tree's train step
    measured by its own ``bench.measure`` (2 warm-up + 5 steps, fused
    and unfused).  Prints one line a turn and, last, the turns as JSON."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.ops import fused_blocks
    pkgs = {"change": {"bench": bench, "ops._build": _build,
                       "ops.fused_blocks": fused_blocks,
                       "ops.flash_attention": flash_attention},
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
        turns.append(res)
        print(f"compare turn {turn} [{smi}]: " + "  ".join(
            f"{k} {v:.4f}" for k, v in res.items() if k != "turn"))
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

    t0 = time.perf_counter()
    report = _build.build_all(ptxas_verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))
    for n, r in report.items():
        fn = None
        for line in r["log"].splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:   # the kernel's mangled name, its anonymous namespace cut
                fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d\d", "",
                            m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  {n}: {fn}: {line.split(':', 1)[-1].strip()}")

    # checkpoints, health, the launcher and the gang runtime: a small
    # model's corruption fallback and crashed commit, bench.py's shape
    # saved, restored and resumed at world size 1, a 2-rank pod killed
    # and relaunched, the gang preset through the bench
    small_ckpt_check(torch, tllama, dist)
    ckpt = ckpt_phase(torch, tbench, tllama, dist, card)
    gang = gang_phase(torch, card)
    gang_bench_line(card)

    int8_rows, int8_err = int8_phase(torch, i8)
    int8_regimes = int8_plans(torch, i8)
    rpa_rows, rpa_err = rpa_phase(torch, rpa)
    quant_rows, quant_err = rpa_phase(torch, rpa, quant=True)
    flash, flash_err, flash_row_err, flash_ctl = flash_phase(torch, fa)
    fused = fused_phase(torch, fb)
    small_reference_check(torch, tllama, convert, rpa)
    small_spec_check(torch, tllama, serving, chaos)
    small_router_check(torch, tllama, serving, chaos)
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
    del params
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
    train_profile(torch, tbench, tllama, card)
    train_profile(torch, tbench, tllama, card, "off")
    # the distributed train step: a small model's topologies as 4 ranks
    # on the card against world size 1, then bench.py's shape at world
    # size 1 over NCCL (in turns with bench.train_step) and as 2 ranks
    # (mp=2, dp=2 + ZeRO-1) over gloo
    small_dist_check(torch, dist)
    dist_res = dist_train_phase(torch, tbench, tllama, dist, card)
    dist_launches = {
        n: dict(ws1_per_step=dist_res["turns"][1]["launches_per_step"][n],
                **{f"{b}_rank0": dist_res["big"][b]["ranks"][0]["launches"][n]
                   for b in dist_res["big"]})
        for n in tbench.KERNELS}
    # the pipeline and context parallelism: a small model's schedules and
    # sp against world size 1, then bench.py's shape at pp=2 under every
    # schedule and at sp=2 (2 ranks over gloo each), then the bench's
    # --multichip line
    small_pp_check(torch, dist)
    pp_res = pipeline_phase(torch, tbench, tllama, dist, card)
    bench_turn = next(t for t in dist_res["turns"] if t["kind"] == "bench")
    cp_res = cp_phase(torch, tbench, tllama, dist, card,
                      bench_turn["losses"][:BIG_STEPS],
                      bench_turn["peak_over_base"])
    multichip_line(card)
    # the MoE layer: bench.py's shape with 8 experts at world size 1, as 2
    # ranks at dp=2 (4 experts a rank), and served
    check(moe_reckoning(moe_cfg(tllama))[:2] == (4_728_358_912,
                                                 4_328_521_728),
          "moe: the model's parameters are not the reckoned 4.73e9")
    moe_train = moe_train_phase(torch, tbench, tllama, dist, card)
    moe_dist = moe_dist_phase(torch, tllama, dist, card, moe_train)
    moe_serve = moe_serve_phase(torch, tllama, serving, bench_serve, card)
    moe_launches = {n: dict(ws1_per_step=moe_train["launches_per_step"][n],
                            dp2_rank0=moe_dist["ranks"][0]["launches"][n])
                    for n in tbench.KERNELS}
    # a rank's launches over the 2 steps of each schedule / of sp=2
    pp_launches = {n: {s: pp_res["ranks"][0]["runs"][s]["launches"][n]
                       for s, _ in PP_BIG_CASES} for n in tbench.KERNELS}
    sp_launches = {n: cp_res["ranks"][0]["runs"]["sp2"]["launches"][n]
                   for n in tbench.KERNELS}

    # one step of the main path: 225 int8 matmuls at M = 8 (decode), 64
    # (the default cell's prefill) and 512 (the long-context prefill),
    # and 32 attention calls at the decode case
    step, pre64, pre512 = (int8_step(int8_rows, M) for M in INT8_ROWS)
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
         "library": "the faster of torch._int_mm on row-major and "
                    "K-contiguous weights, + the epilogue",
         "calls": [{k: r[k] for k in ("M", "K", "N", "ms", "bound_ms",
                                      "plain_ms", "library_ms")}
                   for r in int8_rows],
         "regimes": int8_regimes,
         "launches_by_run": {n: v["int8_matmul"] for n, v in by_run.items()},
         "launches_moe_serve": {n: moe_serve[n]["launches"]["int8_matmul"]
                                for n, _ in MOE_SERVE_RUNS}},
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

    def d64(key):
        return {k: (f64[k][key] if k != "bounds" else f64[k][key][0])
                for k in ("ms", "plain_ms", "library_ms", "bounds")}

    for name, key, lines, extra in (
            ("flash_fwd", "fwd", (543, 313), dict(d64=d64("fwd"))),
            ("flash_bwd", "bwd", (609, 645, 398, 439), dict(
                launches_per="3 kernels a call: delta pre-pass, main, cast",
                kernel_ms=f128["profile"], d64=d64("bwd")))):
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
            row_rel_err=r["row_rel_err"], row_rel_max=ROW_REL_MAX,
            norm_rel_err=r["norm_rel_err"],
            control_row_rel_err=r["control_row_rel_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            composition_ms=r["composition_ms"], kernel_ms=r["kernel_ms"],
            per=per, launches_per=note))
    check(len(kernels["kernels"]) == 9, "the kernels line lists "
          f"{len(kernels['kernels'])} kernels, not 9")
    print(f"moe [{card}]: train {json.dumps(moe_train)}; dist "
          f"{json.dumps(moe_dist)}; serve {json.dumps(moe_serve)}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--gang-worker" in sys.argv[1:]:
        sys.exit(gang_worker(sys.argv[1:]))
    sys.exit(main(sys.argv[1:]))
