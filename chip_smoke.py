#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/ops/csrc``
with nvcc, holds each kernel against its plain PyTorch version at the
serving path's shapes and times both (plus one PyTorch library call for
the same function as a yardstick the port never calls), checks a small
model's serving step on the card against the CPU, then serves 16
requests through ``LLMEngine`` at the full width and depth of the
``llama7b`` preset (random weights from a seed, int8 weights, bf16 KV
pages) and checks that every launch of the path went through the two
kernels.  Any failure exits non-zero.

The last two lines of standard output are the card's name and power
limit (from nvidia-smi) and, last, ``{"ok": true, "device": {...}}``;
the line before them is the ``kernels`` JSON object.
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    print(f"profile [{card}]: {steps} steps, wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for e in rows[:10]:
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
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.ops import _build
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
    small_reference_check(torch, tllama, convert)
    # the main path: llama7b (bf16, 32 layers) on the card
    launches = serve_phase(torch, tllama.preset("llama7b"), tllama,
                           serving, i8, rpa, card, torch.device("cuda"))

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
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
