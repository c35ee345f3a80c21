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
  (float32 and int8 KV pages), then ``paddle_tpu_torch.bench_serve``'s
  measuring function three times at the full width and depth of the
  ``llama7b`` preset (random weights from a seed, int8 weights built
  once): bf16 KV pages, int8 KV pages, and int8 pages under the
  shared-prefix workload with the prefix cache on; every launch counted
  through the int8 matmul and the two ragged paged attention kernels
  (bf16 pools, int8 pools), and the KV pool bytes held to their
  formula; one chunk-64 prefill step of the long-context shape
  (1,024-token prompts) profiled by kernel for each KV type.  Ragged
  paged attention is also held and timed at the long-context cell's
  shapes (decode at 2048 tokens a request, chunk-64 prefill), for both
  pool types;
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
  elementwise, optimizer, copies) that must add up to the busy time.

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
# page boundary); a GQA decode at 2048 tokens; and the long-context
# cell's chunk-64 prefill steps with decode rows mixed in
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


# the three serve runs of one call: (name, kv dtype, workload)
SERVE_RUNS = (("bf16", "bf16", "uniform"), ("int8", "int8", "uniform"),
              ("int8_shared_prefix", "int8", "shared-prefix"))


def serve_phase(torch, tllama, bench_serve, card):
    """The serving main path through ``bench_serve``'s measuring
    function: llama7b at full width and depth, int8 weights built once,
    served three times in one call (bf16 KV; int8 KV; int8 KV with the
    shared-prefix workload and the prefix cache), each uniform run
    followed by its profiles (``profile_steps``, ``prefill_profile``).
    Every launch of the three serving kernels is counted from 0 over each
    run (its warm-up included) and held against the engine's forward
    steps; the KV pool bytes against their formula."""
    cfg = tllama.preset("llama7b")
    L, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    t0 = time.perf_counter()
    params = tllama.quantize_params(
        cfg, tllama.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    print(f"llama7b int8 weights built: {time.perf_counter() - t0:.1f} s")
    runs, outputs = {}, {}
    for name, kv_dtype, workload in SERVE_RUNS:
        bench_serve.reset_kernel_launches()
        run = bench_serve.serve("cuda", kv_dtype=kv_dtype,
                                workload=workload, params=params)
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
        check(launches["int8_matmul"] == (7 * L + 1) * steps,
              f"serve {name}: int8_matmul launched "
              f"{launches['int8_matmul']} times over {steps} steps, "
              f"expected {(7 * L + 1) * steps}")
        quant = kv_dtype == "int8"
        want = {"ragged_paged_attention": 0 if quant else L * steps,
                "ragged_paged_attention_quant": L * steps if quant else 0}
        for k, v in want.items():
            check(launches[k] == v, f"serve {name}: {k} launched "
                  f"{launches[k]} times over {steps} steps, expected {v}")
        page, P = eng.page_size, eng.num_pages
        pool = 2 * L * nkv * P * page * d * (1 if quant else 2)
        scales = 2 * L * nkv * P * 4 if quant else 0
        held = sum(t.numel() * t.element_size() for t in
                   (eng._kp, eng._vp, eng._ks, eng._vs) if t is not None)
        check(eng._pool_bytes == pool + scales == held,
              f"serve {name}: pool bytes {eng._pool_bytes} (held {held}), "
              f"formula {pool} + {scales}")
        if workload == "shared-prefix":
            check(res["reuse"]["prefix_hit_tokens"] > 0,
                  f"serve {name}: no prefix hit")
        res["launches"] = launches
        res["forward_steps"] = steps
        runs[name] = res
        outputs[name] = [list(r.output) for r in reqs]
        print(f"serve {name} [{card}]: BENCH_SERVE {json.dumps(res)}")
        print(f"serve {name} [{card}]: {res['tokens']} tokens in "
              f"{res['wall_seconds']:.3f} s = {res['value']:.2f} tokens/s, "
              f"TTFT p50 {res['ttft_p50_ms']:.2f} ms p95 "
              f"{res['ttft_p95_ms']:.2f} ms, decode step "
              f"{res['decode_step_ms']:.2f} ms, prefill step "
              f"{res['prefill_step_ms']:.2f} ms (means), "
              f"max_memory_allocated {res['max_memory_allocated']} bytes, "
              f"KV pools {eng._pool_bytes} bytes, launches {launches} over "
              f"{steps} forward steps")
        if workload == "uniform":
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
    return runs


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


def load_parent(root):
    """``root``/paddle_tpu_torch imported as ``parent_paddle_tpu_torch``:
    the package imports itself only relatively, so its kernels build from
    its own sources into its own ``build/``."""
    import importlib
    import importlib.util
    import os
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
    from paddle_tpu_torch import bench_serve
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_blocks as fb
    from paddle_tpu_torch.ops import int8_matmul as i8
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

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

    int8_rows, int8_err = int8_phase(torch, i8)
    int8_regimes = int8_plans(torch, i8)
    rpa_rows, rpa_err = rpa_phase(torch, rpa)
    quant_rows, quant_err = rpa_phase(torch, rpa, quant=True)
    flash, flash_err, flash_row_err, flash_ctl = flash_phase(torch, fa)
    fused = fused_phase(torch, fb)
    small_reference_check(torch, tllama, convert, rpa)
    # the serving path: llama7b (32 layers, int8 weights) on the card,
    # bf16 KV, int8 KV, int8 KV + shared prefix
    serve = serve_phase(torch, tllama, bench_serve, card)
    launches = serve["bf16"]["launches"]
    by_run = {n: r["launches"] for n, r in serve.items()}
    for mode in ("on", "off"):
        small_train_check(torch, tllama, mode)
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
         "launches_by_run": {n: v["int8_matmul"] for n, v in by_run.items()}},
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
                             for n, v in by_run.items()}},
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
                             for n, v in by_run.items()}},
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
            row_rel_err=r["row_rel_err"], row_rel_max=ROW_REL_MAX,
            norm_rel_err=r["norm_rel_err"],
            control_row_rel_err=r["control_row_rel_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            composition_ms=r["composition_ms"], kernel_ms=r["kernel_ms"],
            per=per, launches_per=note))
    check(len(kernels["kernels"]) == 9, "the kernels line lists "
          f"{len(kernels['kernels'])} kernels, not 9")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
