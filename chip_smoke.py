#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/ops/csrc``
with nvcc (one nvcc per source, started together), holds each kernel
against its plain PyTorch version at its main path's shapes and times
both (plus one PyTorch library call for the same function as a
yardstick the port never calls), then drives the two main paths:

- serving: a small model's serving step on the card against the CPU,
  then 16 requests through ``LLMEngine`` at the full width and depth of
  the ``llama7b`` preset (random weights from a seed, int8 weights, bf16
  KV pages), every launch counted through the int8 matmul and ragged
  paged attention kernels;
- training: the four fused decoder-block kernels against their plain
  versions at the bench shape (timed beside the unfused PyTorch
  composition of each block), a small bf16 train step on the card
  against the CPU in f32 with the fused blocks on and off, then
  ``paddle_tpu_torch.bench``'s train step at bench.py's ~0.95B shape
  (S = 2048, AdamW) for warmup + 5 timed steps at the default policy
  (the fused blocks, every launch counted through their four kernels
  and the flash backward pair), the same unfused (every launch counted
  through the three flash kernels), and one profiled fused step.

Any failure exits non-zero.  The last two lines of standard output are
the card's name and power limit (from nvidia-smi) and, last,
``{"ok": true, "device": {...}}``; the line before them is the
``kernels`` JSON object.
"""
import json
import math
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


def int8_phase(torch, i8):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, max_err = [], 0.0
    for M in (8, 64):
        for (K, N), calls in INT8_SHAPES.items():
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            w = torch.randn((K, N), generator=gen, device=dev) * 0.02
            wq, ws = i8.quantize_int8(w)
            del w
            y = i8.int8_matmul(x, wq, ws)
            ref = i8._int8_matmul_plain(x, wq, ws)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            check(torch.equal(y, ref),
                  f"int8_matmul M={M} K={K} N={N} not bit-identical "
                  f"(max |diff| {err})")
            max_err = max(max_err, err)
            # the weights of one call are cold in a real step (every
            # layer has its own): rotate through copies that exceed L2
            copies = [wq] + [wq.clone() for _ in
                             range(max(0, math.ceil(160e6 / wq.numel()) - 1))]
            def kern(i):
                return i8.int8_matmul(x, copies[i % len(copies)], ws)

            ms = time_ms(torch, kern, calls=20)
            host_ms = eager_ms(torch, kern, calls=50)
            plain_ms = time_ms(torch, lambda i: i8._int8_matmul_plain(
                x, copies[i % len(copies)], ws), calls=4, replays=2)
            lib_ms = int_mm_ms(torch, i8, x, copies, ws)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            b_ms, _ = bound_ms(nbytes, 2 * M * K * N, "int8")
            rows.append(dict(M=M, K=K, N=N, calls=calls, ms=ms,
                             eager_ms=host_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bytes=nbytes,
                             ops=2 * M * K * N))
            print(f"int8_matmul M={M:3d} K={K:5d} N={N:5d}: kernel "
                  f"{ms:.4f} ms (eager {host_ms:.4f})  plain "
                  f"{plain_ms:.4f} ms  _int_mm "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
                  f"bound {b_ms:.4f} ms  bit-identical")
            del copies, wq, ws, x, y, ref
    return rows, max_err


def int_mm_ms(torch, i8, x, copies, ws):
    """torch._int_mm (cuBLASLt) plus the dequant epilogue on the same
    int8 operands; _int_mm needs more than 16 rows, so smaller M is
    padded to 32 zero rows."""
    xq, xs = i8._quantize_rows(x.float())
    M = xq.shape[0]
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros((32 - M, xq.shape[1]))])

    def run(i):
        acc = torch._int_mm(xq, copies[i % len(copies)])[:M]
        return ((acc.float() * xs) * ws).to(x.dtype)

    try:
        run(0)
    except RuntimeError as exc:  # a library limit, not the port's kernel
        print(f"  torch._int_mm unavailable here: {exc}")
        return None
    return time_ms(torch, run, calls=20)


# R = 8 slots, llama7b's heads; mixed kv lengths with an empty slot and
# chunks across page boundaries; the last case is GQA (rep = 4)
RPA_CASES = [
    ("prefill_tc8", 32, 1, 8, [8, 20, 0, 33, 24, 16, 40, 9],
     [8, 4, 0, 8, 8, 3, 8, 2]),
    ("decode_tc1", 32, 1, 1, [1, 17, 33, 40, 0, 9, 2, 25],
     [1, 1, 1, 1, 0, 1, 1, 1]),
    ("gqa_rep4_tc8", 8, 4, 8, [8, 20, 0, 33, 24, 16, 40, 9],
     [8, 4, 0, 8, 8, 3, 8, 2]),
]


def rpa_phase(torch, rpa):
    F = torch.nn.functional
    dev = torch.device("cuda")
    R, d, page, Bmax, P = 8, 128, 16, 3, 64
    rng = np.random.RandomState(2)
    rows, max_err = [], 0.0
    for name, nkv, rep, Tc, lens_l, qlens_l in RPA_CASES:
        Tr = Tc * rep
        q = torch.from_numpy(rng.standard_normal((R, nkv, Tr, d)).astype(
            np.float32)).to(dev, torch.bfloat16)
        kp, vp = (torch.from_numpy(rng.standard_normal(
            (nkv, P, page, d)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
        tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                               .reshape(R, Bmax).astype(np.int32)).to(dev)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        qlens = torch.tensor(qlens_l, dtype=torch.int32, device=dev)
        args = (q, kp, vp, tbl, lens, qlens)
        out = rpa.ragged_paged_attention(*args, rep=rep)
        ref = rpa._ragged_attention_plain(*args, rep)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tok = torch.arange(Tr, device=dev) // rep
        pad = (tok[None, :] >= qlens[:, None])[:, None, :, None].expand_as(
            out)
        pad_zero = not out[pad].any().item()
        check(err <= 2e-2, f"attention {name}: max |diff| {err} > 2e-2")
        check(pad_zero, f"attention {name}: padding rows not exact zeros")
        max_err = max(max_err, err)
        def kern(i):
            return rpa.ragged_paged_attention(*args, rep=rep)

        ms = time_ms(torch, kern, calls=50)
        host_ms = eager_ms(torch, kern, calls=100)
        plain_ms = time_ms(torch, lambda i: rpa._ragged_attention_plain(
            *args, rep), calls=10)
        # yardstick: SDPA over each request's kv gathered dense (gather
        # and mask built outside the timed call)
        S = Bmax * page
        flat = tbl.reshape(-1).long()
        kd = kp.index_select(1, flat).reshape(nkv, R, S, d).transpose(0, 1)
        vd = vp.index_select(1, flat).reshape(nkv, R, S, d).transpose(0, 1)
        kd, vd = kd.contiguous(), vd.contiguous()
        kpos = torch.arange(S, device=dev)
        qpos = (lens - qlens)[:, None] + tok[None, :]
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < lens[:, None, None])
                & (tok[None, :, None] < qlens[:, None, None]))[:, None]
        lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), calls=50)
        # bytes this data needs: q and out once, the K and V of every
        # visible token once; ops: q.k and p.v for every visible pair
        visible = sum(L for L, ql in zip(lens_l, qlens_l) if ql)
        pairs = sum(ql * rep * ((L - ql) + (ql + 1) / 2)
                    for L, ql in zip(lens_l, qlens_l))
        nbytes = 2 * (2 * q.numel()) + 2 * visible * nkv * d * 2
        ops = 4 * pairs * nkv * d
        b_ms, _ = bound_ms(nbytes, ops, "bf16")
        rows.append(dict(name=name, nkv=nkv, rep=rep, Tc=Tc, ms=ms,
                         eager_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bytes=nbytes, ops=ops,
                         max_abs_err=err))
        print(f"ragged_paged_attention {name}: kernel {ms:.4f} ms (eager "
              f"{host_ms:.4f})  plain "
              f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
              f"{b_ms:.6f} ms  max |diff| {err:.3g}  padding exact 0")
    return rows, max_err


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def small_reference_check(torch, tllama, convert):
    """One mixed prefill + decode step of a small float32 model with int8
    weights: the card (both kernels) against the CPU (plain versions).
    They agree to float32 summation order, except where an activation
    sits within an ulp of an int8 rounding boundary on one side only;
    each such flip moves an output by at most x_scale * max|w| (~3e-3
    here), hence atol 1e-2."""
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
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                           .reshape(R, Bmax).astype(np.int32))
    lens = torch.tensor([8, 21, 0, 40], dtype=torch.int32)
    qlens = torch.tensor([8, 1, 0, 6], dtype=torch.int32)
    tokens = torch.from_numpy(rng.randint(0, 512, (R, Tc)).astype(np.int32))
    outs = []
    for dev in ("cpu", "cuda"):
        k_dev, v_dev = kp.clone().to(dev), vp.clone().to(dev)
        with torch.no_grad():
            logits, _ = tllama.forward_paged(
                cfg, convert.params_to(params, dev), tokens.to(dev), k_dev,
                v_dev, tbl.to(dev), lens.to(dev), qlens.to(dev))
        outs.append((logits.cpu(), k_dev.cpu(), v_dev.cpu()))
    err = 0.0
    for r, q in enumerate(qlens.tolist()):
        err = max(err, (outs[0][0][r, :q] - outs[1][0][r, :q]).abs().max()
                  .item() if q else 0.0)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        err = max(err, (a[:, :, 1:] - b[:, :, 1:]).abs().max().item())
    check(all(torch.isfinite(o[0]).all() for o in outs), "non-finite logits")
    check(err <= 1e-2, f"small model: card vs CPU max |diff| {err} > 1e-2")
    print(f"small model step (f32, int8 weights): card vs CPU max |diff| "
          f"{err:.3g} (atol 1e-2)")


def serve_phase(torch, cfg, tllama, serving, i8, rpa, card, device):
    n_req, max_prompt, n_new, chunk = 16, 24, 16, 8
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    params = tllama.init_params(cfg, seed=0, device=device)
    eng = serving.LLMEngine(cfg, params, device=device, max_running=8,
                            chunk=chunk, page_size=16,
                            max_model_len=max_prompt + n_new + chunk)
    del params                                    # the engine holds int8
    torch.cuda.synchronize()
    check(isinstance(eng.params["layers"]["wq"], dict),
          "quantized='auto' did not quantize on CUDA")
    print(f"engine built ({L} layers, hidden {cfg.hidden_size}, int8 "
          f"weights, {eng._kp.dtype} KV pages, {eng.num_pages} pages of "
          f"16): {time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, cfg.vocab_size,
                                rng.randint(2, max_prompt + 1)))
               for _ in range(n_req)]
    # warm-up request (first-call costs), then the measured run
    eng.add_request(prompts[0], 2)
    eng.run()
    eng._step_wall_s.clear()
    torch.cuda.reset_peak_memory_stats()

    i8.int8_matmul.launches = 0
    rpa.ragged_paged_attention.launches = 0
    t_start = time.monotonic()
    rids = [eng.add_request(p, n_new) for p in prompts[:n_req // 2]]
    pending = list(prompts[n_req // 2:])
    steps = 0
    while eng.has_work() or pending:
        if pending and steps % 2 == 1:
            rids.append(eng.add_request(pending.pop(0), n_new))
        eng.step()
        steps += 1
        check(steps < 10000, "serve loop did not converge")
    wall = time.monotonic() - t_start
    launches = {"int8_matmul": i8.int8_matmul.launches,
                "ragged_paged_attention":
                    rpa.ragged_paged_attention.launches}

    reqs = [eng.request(r) for r in rids]
    check(all(r.state is serving.RequestState.FINISHED for r in reqs),
          "a request did not finish")
    check(all(len(r.output) == n_new for r in reqs),
          "a request finished short")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
          "a token id out of the vocabulary")
    check(eng.kv.allocator.num_allocated == 0 and eng.kv.audit()["ok"],
          f"page books not balanced: {eng.kv.audit()}")
    fwd = sum(len(v) for v in eng._step_wall_s.values())
    check(launches["int8_matmul"] == (7 * L + 1) * fwd,
          f"int8_matmul launched {launches['int8_matmul']} times over "
          f"{fwd} steps, expected {(7 * L + 1) * fwd} (7 x {L} + 1 per "
          f"step)")
    check(launches["ragged_paged_attention"] == L * fwd,
          f"ragged_paged_attention launched "
          f"{launches['ragged_paged_attention']} times over {fwd} steps, "
          f"expected {L * fwd}")

    tokens = sum(len(r.output) for r in reqs)
    ttft = [r.first_token_s - r.arrival_s for r in reqs]
    dec = eng._step_wall_s.get(1, [])
    pre = eng._step_wall_s.get(chunk, [])
    peak = torch.cuda.max_memory_allocated()
    print(f"serve [{card}]: {n_req} requests x {n_new} new tokens, "
          f"{fwd} steps ({len(pre)} prefill, {len(dec)} decode), "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} tokens/s")
    print(f"serve [{card}]: TTFT p50 {1e3 * np.percentile(ttft, 50):.2f} ms"
          f"  p95 {1e3 * np.percentile(ttft, 95):.2f} ms  decode step "
          f"{1e3 * np.mean(dec):.2f} ms  prefill step "
          f"{1e3 * np.mean(pre):.2f} ms (means)")
    print(f"serve [{card}]: max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    print(f"serve [{card}]: launches {launches} = per step "
          f"{7 * L + 1} int8_matmul, {L} ragged_paged_attention")
    profile_steps(torch, eng, prompts[:8], card)
    return launches


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


# ---------------------------------------------------------------------------
# flash attention (the train path's kernels)
# ---------------------------------------------------------------------------

# (B, S, H, D): tails (S = 1, 17, 200), both head dims, the bench shape last
FLASH_CASES = [(1, 1, 2, 128), (2, 17, 3, 64), (1, 200, 2, 128),
               (4, 2048, 16, 128)]


def flash_bounds(B, S, H, D):
    """(bytes, ops) each flash function must move and do: every input read
    once and every output written once; the causal pairs only
    (S (S + 1) / 2 per head), 2 D ops per pair per matmul product (fwd
    2: s, p.v; dq 3: s, dp, ds.k; dkv 4: s, dp, p^T.do, ds^T.q).  The
    backward as one function (dq, dk, dv from q, k, v, o, do, lse) needs
    5 products; "pair_split" counts the 7 that the dq/dkv split
    computes, s and dp twice."""
    x, rows = 2 * B * S * H * D, 4 * B * H * S
    pairs = B * H * S * (S + 1) // 2
    return {"fwd": (3 * x + x + rows, 4 * D * pairs),
            "dq": (5 * x + rows + x + rows, 6 * D * pairs),
            "dkv": (4 * x + 2 * rows + 2 * x, 8 * D * pairs),
            "pair": (5 * x + rows + 3 * x, 10 * D * pairs),
            "pair_split": (5 * x + rows + 3 * x, 14 * D * pairs)}


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


def flash_phase(torch, fa):
    """Each flash kernel against its plain version (run in f32 on the same
    bf16 inputs): o max |diff| <= 2e-2 (bf16 output, values ~1); each
    gradient max |diff| / max |ref| <= 2e-2 (bf16 p and ds feed the
    tensor cores); lse max |diff| <= 1e-3; and o, dq, dk, dv each within
    ``ROW_REL_MAX`` per row and ``NORM_REL_MAX`` over the tensor
    (``rms_rel``).  Controlled and timed at the bench shape."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    row_errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    timing = control = None
    for B, S, H, D in FLASH_CASES:
        rng = np.random.RandomState(S + D)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, S, H, D)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
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
        for key, ns in (("fwd", ("o",)), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            row_errs[key] = max([row_errs[key]] + [e_row[n] for n in ns])
        errs["fwd"] = max(errs["fwd"], e_o)
        errs["dq"] = max(errs["dq"], (dq.float() - dq_ref).abs().max().item())
        errs["dkv"] = max(errs["dkv"], (dk.float() - dk_ref).abs().max()
                          .item(), (dv.float() - dv_ref).abs().max().item())
        print(f"flash {shape}: o {e_o:.3g}  lse {e_lse:.3g}  rel dq "
              f"{e_g['dq']:.3g} dk {e_g['dk']:.3g} dv {e_g['dv']:.3g}; row "
              "rel " + "  ".join(f"{n} {e_row[n]:.3g}" for n in got)
              + "; norm rel " + "  ".join(f"{n} {e_norm[n]:.3g}"
                                          for n in got))
        del f32, o_ref, lse_ref, dq_ref, dk_ref, dv_ref, got
        if (B, S, H, D) == FLASH_CASES[-1]:
            control = flash_control(torch, q, k, v, do)
            timing = flash_timing(torch, F, fa, q, k, v, do, o, lse, delta)
    return timing, errs, row_errs, control


def flash_timing(torch, F, fa, q, k, v, do, o, lse, delta):
    B, S, H, D = q.shape
    ms = {
        "fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v), calls=20),
        "dq": time_ms(torch, lambda i: fa.flash_bwd_dq(q, k, v, o, lse, do),
                      calls=20),
        "dkv": time_ms(torch, lambda i: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta), calls=20),
        "pair": time_ms(torch, lambda i: fa.flash_bwd_dkv(
            q, k, v, do, lse, fa.flash_bwd_dq(q, k, v, o, lse, do)[1]),
            calls=10),
    }
    plain = {
        "fwd": time_ms(torch, lambda i: fa._flash_fwd_plain(q, k, v),
                       calls=2, replays=2),
        "dq": time_ms(torch, lambda i: fa._flash_bwd_dq_plain(
            q, k, v, o, lse, do), calls=2, replays=2),
        "dkv": time_ms(torch, lambda i: fa._flash_bwd_dkv_plain(
            q, k, v, do, lse, delta), calls=2, replays=2),
        "pair": time_ms(torch, lambda i: fa._flash_bwd_plain(
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
    lib["pair"] = lib["fwd_bwd"] - lib["fwd"]
    bounds = {n: bound_ms(*flash_bounds(B, S, H, D)[n], "bf16")
              for n in ("fwd", "dq", "dkv", "pair", "pair_split")}
    shape = f"B={B} S={S} H={H} D={D}"
    for n in ("fwd", "dq", "dkv", "pair"):
        sdpa = (f"{lib[n]:.4f} ms" if n in lib
                else "n/a (no one call computes it alone)")
        print(f"flash {n} {shape}: kernel {ms[n]:.4f} ms  plain "
              f"{plain[n]:.4f} ms  sdpa {sdpa}  bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]})")
    print(f"flash pair {shape}: bound of the split's 7 products "
          f"{bounds['pair_split'][0]:.4f} ms (the function needs 5)")
    print(f"flash fwd+bwd {shape}: kernels {ms['fwd'] + ms['pair']:.4f} ms"
          f"  sdpa {lib['fwd_bwd']:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bounds": bounds}


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
    the unfused composition."""
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
    for n in names:
        ms = time_ms(torch, lambda i: args[n](), calls=10)
        plain_ms = time_ms(torch, lambda i: plain[n](), calls=2, replays=2)
        comp_ms = time_ms(torch, lambda i: comp[n](), calls=10)
        b_ms, b_by = bound_ms(*bounds[n], "bf16")
        res[n].update(ms=ms, plain_ms=plain_ms, composition_ms=comp_ms,
                      bound_ms=b_ms, bound_by=b_by,
                      control_row_rel_err=control[n])
        print(f"{n}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"composition {comp_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
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
    per_step = {"flash_fwd": 0 if fused else fwd, "flash_bwd_dq": L,
                "flash_bwd_dkv": L,
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


def train_profile(torch, tbench, tllama, card):
    """Where a train step's time goes: one warmup step, then one step of
    the fused path (the default policy) under torch.profiler at the
    bench's first rung; device time by kernel and the device's busy
    share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    policy, B = tbench.LADDER[0]
    cfg = tllama.LlamaConfig(remat_policy=policy, **tbench.MODEL)
    check(tllama._fused_block_modes(cfg, torch.zeros(1, device="cuda"))
          == (True, True), "the profiled step is not the fused one")
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
    print_profile(prof, wall_us, f"profile train [{card}]: 1 fused step",
                  20)


def print_profile(prof, wall_us, head, top):
    """Device time by kernel and the busy share.  Only kernels and copies
    count: a CPU op's row repeats the device time of the kernels it
    launched, and a user annotation's device row (``Optimizer.step``)
    spans kernels that have rows of their own."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return e.self_device_time_total

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and not e.is_user_annotation),
                  key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    print(f"{head}, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}% of wall)")
    for e in rows[:top]:
        if dev_us(e) > 0:
            print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")


def main():
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
    from paddle_tpu_torch import serving
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

    t0 = time.perf_counter()
    report = _build.build_all(ptxas_verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))
    for n, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {n}: {line.strip()}")

    int8_rows, int8_err = int8_phase(torch, i8)
    rpa_rows, rpa_err = rpa_phase(torch, rpa)
    flash, flash_err, flash_row_err, flash_ctl = flash_phase(torch, fa)
    fused = fused_phase(torch, fb)
    small_reference_check(torch, tllama, convert)
    # the serving path: llama7b (bf16, 32 layers) on the card
    launches = serve_phase(torch, tllama.preset("llama7b"), tllama,
                           serving, i8, rpa, card, torch.device("cuda"))
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

    # one decode step of the main path: 225 int8 matmuls at M = 8 and 32
    # attention calls at the decode case
    dec = [r for r in int8_rows if r["M"] == 8]
    step = {k: sum(r["calls"] * r[k] for r in dec)
            for k in ("ms", "plain_ms", "bound_ms", "bytes", "ops")}
    lib = (None if any(r["library_ms"] is None for r in dec)
           else sum(r["calls"] * r["library_ms"] for r in dec))
    _, int8_by = bound_ms(step["bytes"], step["ops"], "int8")
    att = next(r for r in rpa_rows if r["name"] == "decode_tc1")
    _, att_by = bound_ms(att["bytes"], att["ops"], "bf16")
    kernels = {"kernels": [
        {"name": "int8_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/int8_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas_ops.py:2276",
         "launches": launches["int8_matmul"],
         "max_abs_err": int8_err, "ms": step["ms"],
         "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
         "bound_by": int8_by, "library_ms": lib,
         "eager_ms": sum(r["calls"] * r["eager_ms"] for r in dec),
         "per": "one llama7b decode step: 225 calls at M=8"},
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas_ops.py:1781",
         "launches": launches["ragged_paged_attention"],
         "max_abs_err": rpa_err, "ms": 32 * att["ms"],
         "plain_ms": 32 * att["plain_ms"], "bound_ms": 32 * att["bound_ms"],
         "bound_by": att_by, "library_ms": 32 * att["library_ms"],
         "eager_ms": 32 * att["eager_ms"],
         "per": "one llama7b decode step: 32 calls, R=8, Tc=1, page 16"},
    ]}
    # the flash kernels, per call at the bench shape; no one library call
    # computes dq or dk/dv alone, so those carry the pair's SDPA backward
    per = "one call at B=4 S=2048 H=16 D=128 (the bench step's shape)"
    src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    pair = {"pair_ms": flash["ms"]["pair"],
            "pair_plain_ms": flash["plain_ms"]["pair"],
            "pair_bound_ms": flash["bounds"]["pair"][0],
            "pair_split_bound_ms": flash["bounds"]["pair_split"][0],
            "pair_library_ms": flash["library_ms"]["pair"]}
    # each replaces a resident body and its streamed twin (one TPU
    # VMEM-capacity split)
    for name, key, line, twin, lib_ms, extra in (
            ("flash_fwd", "fwd", 543, 313, flash["library_ms"]["fwd"], {}),
            ("flash_bwd_dq", "dq", 609, 398, None, pair),
            ("flash_bwd_dkv", "dkv", 645, 439, None, pair)):
        kernels["kernels"].append(dict(
            name=name, route="cuda", source=src,
            replaces=f"paddle_tpu/ops/pallas_ops.py:{line}",
            also_replaces=f"paddle_tpu/ops/pallas_ops.py:{twin}",
            launches=train_launches[name],
            launches_fused_step=fused_launches[name],
            max_abs_err=flash_err[key],
            row_rel_err=flash_row_err[key], row_rel_max=ROW_REL_MAX,
            control_row_rel_err=min(
                flash_ctl[n] for n in {"fwd": ("o",), "dq": ("dq",),
                                       "dkv": ("dk", "dv")}[key]),
            ms=flash["ms"][key], plain_ms=flash["plain_ms"][key],
            bound_ms=flash["bounds"][key][0],
            bound_by=flash["bounds"][key][1], library_ms=lib_ms, per=per,
            **extra))
    # the fused blocks, per call at the bench shape; no one PyTorch call
    # computes any of them, so the unfused composition stands beside
    per = "one call at B=4 S=2048 H=2048 D=128 I=5632 (the bench step's)"
    src = "paddle_tpu_torch/ops/csrc/fused_blocks.cu"
    for name, line, note in (
            ("fused_qkv", 1130, "row pass (xn) + one GEMM launch over q, k, v"),
            ("fused_attn_epilogue", 1200,
             "two launches: flash_fwd's kernel (attn, lse), then the GEMM "
             "y = x + attn wo"),
            ("fused_mlp_fwd", 1417,
             "row pass + GEMM [g | u] with silu*mul epilogue + GEMM a wd + x"),
            ("fused_mlp_bwd_dx", 1444,
             "row pass + GEMM g, u (f32) + GEMM dy wd^T with dg, du epilogue"
             " + GEMM [dg | du] [wg | wu]^T + RMSNorm-backward row pass")):
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
            composition_ms=r["composition_ms"], per=per, launches_per=note))
    check(len(kernels["kernels"]) == 9, "the kernels line lists "
          f"{len(kernels['kernels'])} kernels, not 9")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
