"""Single-card Llama train-step bench of the port (the counterpart of
``bench.py``'s one-chip MFU bench).  Run from the repository root:

    python -m paddle_tpu_torch.bench                 # on the card
    python -m paddle_tpu_torch.bench --device cpu    # CPU smoke shape
    python -m paddle_tpu_torch.bench --multichip [--trace-out DIR]
    python -m paddle_tpu_torch.bench --multichip --gang N [--trace-out DIR]

On the card it trains the ~0.95B Llama of ``bench.py`` (vocab 32000,
hidden 2048, intermediate 5632, 16 layers, 16 heads of 128, bf16) at
sequence 2048, going down the remat/batch ladder
``[("dots", 4), ("full", 4), ("full", 2)]`` when a rung runs out of
device memory.  A step is zero-grad -> ``loss_fn`` -> backward ->
``torch.optim.AdamW`` (optax ``adamw(3e-4, b1=0.9, b2=0.95,
weight_decay=0.1)``: every leaf decays, moments in the param dtype).
On the card the layers take the fused decoder blocks (``fused_blocks``
"auto", the reference's default; the result line says which blocks
engaged), the CPU smoke shape the unfused layer with plain attention;
any error other than running out of memory ends the run.

``--multichip`` is the port of ``bench.py``'s ``multichip_main``
(``bench.py:308-468``): ``Plan(dp=2, pp=2, mp=2, schedule="1f1b")``
as 8 ranks (``distributed.spawn``; on one card over gloo, whose
point-to-point calls cross through host memory), the 1F1B schedule
overlapped against lockstep on the same model and batch, 1 + 5 steps
each.  It reports both step times (host-staged gloo on one card: no
throughput), the losses, the static schedule's overlap fractions and
serialized transfers, the measured ones scored from the schedule the
flight recorder took (with ``--trace-out``: one sidecar a rank there,
``matches_static``), the modeled collective bytes a step and the
collective metrics.  The model is ``bench.py``'s tiny float32 one on
the CPU; on the card the flash kernels need bfloat16 and head dim 64,
so it is that model at hidden 256 (4 heads of 64), intermediate 512,
in bfloat16.

``--multichip --gang N`` is the port of ``bench.py``'s
``multichip_gang_main`` (``bench.py:496-590``): the gang runtime's
preset (``python -m paddle_tpu_torch.distributed.gang``: ``pp=N`` 1F1B
over 4 microbatches, the same model) run as N real worker processes
through ``python -m paddle_tpu_torch.distributed.launch`` (on one card
over gloo); the ranks' ``GANG_RESULT`` lines fold into one result with
``real_processes``, and a rank whose losses differ from rank 0's, or
whose recorded schedule differs from the static one, fails the run.

It prints one JSON line on every exit path and exits non-zero when the
run failed.  MFU is ``bench.py``'s formula (6 N tokens + causal
attention 6 B S^2 hidden L) over the card's dense bf16 peak, looked up
by the card's name; for a card not in the table it is null.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models import llama
from .ops import flash_attention as fa
from .ops import fused_blocks as fb

# dense bf16 tensor-core peak (TFLOP/s) by card name, from NVIDIA's data
# sheets (the sparse figure halved); first match wins
PEAK_BF16_TFLOPS = (
    ("H100 80GB HBM3", 989.4),   # H100 SXM
    ("H100 PCIe", 756.5),
    ("H200", 989.4),             # H200 SXM
)

# bench.py:100-105 and its ladder (line 99)
MODEL = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
             num_hidden_layers=16, num_attention_heads=16,
             num_key_value_heads=16, max_position_embeddings=2048,
             dtype=torch.bfloat16, use_remat=True)
LADDER = (("dots", 4), ("full", 4), ("full", 2))
SEQ, ITERS, WARMUP = 2048, 10, 2
# bench.py:107-113, the CPU smoke shape
SMOKE = dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=512,
             dtype=torch.float32, use_remat=False)
SMOKE_LADDER = (("full", 2),)
SMOKE_SEQ, SMOKE_ITERS, SMOKE_WARMUP = 256, 3, 1
# every kernel wrapper of the train path, by the name its launches are
# reported under
KERNELS = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
           "fused_qkv": fb.fused_qkv,
           "fused_attn_epilogue": fb.fused_attn_epilogue,
           "fused_mlp_fwd": fb.fused_mlp_fwd,
           "fused_mlp_bwd_dx": fb.fused_mlp_bwd_dx}


def peak_bf16_flops(card: str) -> Optional[float]:
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in card:
            return tflops * 1e12
    return None


def gpu_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"unknown ({exc})"


def make_batch(cfg, B, S, device):
    """bench.py:164-170: ids, then labels, from default_rng(0)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    return {"input_ids": torch.from_numpy(ids).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def make_optimizer(params):
    """AdamW over every leaf, norms and embed included (optax ``adamw``
    with no mask): ``llama.adamw``, the distributed step's too."""
    return llama.adamw(leaves(params))


def train_step(cfg, params, opt, batch):
    """One step; returns the cross-entropy before the update."""
    opt.zero_grad(set_to_none=True)
    total, ce = llama.loss_fn(cfg, params, batch)
    total.backward()
    opt.step()
    return ce.detach()


def model_flops(n_params, B, S, cfg):
    """bench.py:243-246: 6 N tokens + causal attention fwd+bwd."""
    return (6.0 * n_params * B * S
            + 6.0 * B * S * S * cfg.hidden_size * cfg.num_hidden_layers)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rung(base, policy, B, S, iters, warmup, device):
    cfg = llama.LlamaConfig(remat_policy=policy, **base)
    params = llama.init_params(cfg, 0, device=device)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = make_optimizer(params)
    batch = make_batch(cfg, B, S, device)
    losses = [train_step(cfg, params, opt, batch) for _ in range(warmup)]
    _sync(device)
    launches0 = {n: w.launches for n, w in KERNELS.items()}
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(train_step(cfg, params, opt, batch))
    _sync(device)
    step_s = (time.perf_counter() - t0) / iters
    attn, mlp = llama._fused_block_modes(cfg, batch["input_ids"])
    return dict(cfg=cfg, step_s=step_s, B=B,
                losses=[float(x) for x in losses],
                n_params=sum(t.numel() for t in leaves(params)),
                fused_blocks={"attention": attn, "mlp": mlp},
                launches_per_step={
                    n: (w.launches - launches0[n]) / iters
                    for n, w in KERNELS.items()})


def measure(device=None, iters=None, warmup=None, fused_blocks=None):
    """Run the ladder on ``device`` (the card unless the caller names
    another; the CPU takes the smoke shape) and return the result
    dict.  ``fused_blocks`` is the model's policy (None = "auto")."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    base, ladder, S = ((MODEL, LADDER, SEQ) if on_card
                       else (SMOKE, SMOKE_LADDER, SMOKE_SEQ))
    base = dict(base, fused_blocks=fused_blocks)
    if iters is None:
        iters = ITERS if on_card else SMOKE_ITERS
    if warmup is None:
        warmup = WARMUP if on_card else SMOKE_WARMUP
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    run, oom = None, []
    for policy, B in ladder:
        try:
            run = run_rung(base, policy, B, S, iters, warmup, dev)
            break
        except torch.cuda.OutOfMemoryError as exc:
            # keep the message only: the traceback would pin the rung's
            # tensors while the next one runs
            oom.append(f"{policy}/B={B}: {str(exc)[:200]}")
            del exc
            gc.collect()
            torch.cuda.empty_cache()
    if run is None:
        raise RuntimeError("every rung of the ladder ran out of memory: "
                           + "; ".join(oom))
    cfg, B, dt = run["cfg"], run["B"], run["step_s"]
    flops = model_flops(run["n_params"], B, S, cfg)
    peak = peak_bf16_flops(card) if on_card else None
    mfu = None if peak is None else 100.0 * flops / dt / peak
    result = {
        "metric": "llama_train_mfu_1card",
        "value": mfu,
        "unit": "percent_mfu",
        "tokens_per_sec": B * S / dt,
        "step_ms": 1e3 * dt,
        "n_params": run["n_params"],
        "batch": B, "seq": S,
        "remat_policy": cfg.remat_policy if cfg.use_remat else "none",
        "attention": "cuda_flash" if on_card else "plain_cpu",
        "device": card,
        "gpu": gpu_line() if on_card else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None),
        "model_flops_per_step": flops,
        "iters": iters, "warmup": warmup,
        "loss_step0": run["losses"][0], "loss_last": run["losses"][-1],
        "fused_blocks": run["fused_blocks"],
        "launches_per_step": run["launches_per_step"],
        "oom_rungs": oom,
    }
    if mfu is None:
        result["mfu_note"] = (
            "not a card: MFU is a device metric" if not on_card else
            f"no dense bf16 peak known for {card!r}; not guessed")
    return result


# bench.py:335-352, the multichip preset: dp=2 x pp=2 x mp=2, 1F1B over
# 4 microbatches of a global batch of 8 x 32
MULTICHIP_PLAN = dict(dp=2, pp=2, mp=2)
MULTICHIP_MICRO, MULTICHIP_SHAPE, MULTICHIP_ITERS = 4, (8, 32), 5
MULTICHIP_MODEL = dict(vocab_size=256, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=4,
                       num_attention_heads=4, num_key_value_heads=4,
                       max_position_embeddings=64, dtype=torch.float32,
                       use_remat=False)
# on the card: the flash kernels take bf16 at head dim 64 or 128
MULTICHIP_MODEL_CARD = dict(MULTICHIP_MODEL, hidden_size=256,
                            intermediate_size=512, dtype=torch.bfloat16)


def _multichip_rank(device, trace_out):
    """One rank of ``multichip``: the overlapped 1F1B plan, then the
    lockstep one, on the same model and batch."""
    from . import flags
    from .distributed import collective as C
    from .distributed.plan import Plan
    from .profiler import metrics, trace
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)      # 8 ranks share the host's cores
    flags.set_flags({"FLAGS_tpu_metrics": True,
                     "FLAGS_tpu_trace": trace_out is not None})
    cfg = llama.LlamaConfig(**(MULTICHIP_MODEL_CARD if dev.type == "cuda"
                               else MULTICHIP_MODEL))
    B, S = MULTICHIP_SHAPE
    batch_host = make_batch(cfg, B, S, "cpu")

    def run(overlap):
        plan = Plan(schedule="1f1b", n_microbatches=MULTICHIP_MICRO,
                    overlap=overlap, **MULTICHIP_PLAN)
        step, init = plan.train_step(
            cfg, device=dev,
            optimizer=lambda ts: torch.optim.SGD(ts, lr=1e-3))
        params, opt = init(0)
        batch = step.plan_topology.shard_batch(
            {k: v.to(dev) for k, v in batch_host.items()})
        _, _, m = step(params, opt, batch)          # the first step
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(MULTICHIP_ITERS):
            _, _, m = step(params, opt, batch)
        loss = m["loss"].item()
        return 1e3 * (time.perf_counter() - t0) / MULTICHIP_ITERS, loss, \
            sum(t.numel() for t in leaves(params))

    overlap_ms, loss_o, n_local = run(True)
    events_o = trace.events() if trace_out else []
    lockstep_ms, loss_l, _ = run(False)
    events = trace.events() if trace_out else []
    rank = torch.distributed.get_rank()
    sidecar = None
    if trace_out:
        os.makedirs(trace_out, exist_ok=True)
        sidecar = trace.write_sidecar(
            trace.sidecar_path(trace_out, rank),
            extra={"bench": "multichip", "devices": 8})
    n_params = sum(t.numel() for t in leaves(llama.init_params(
        cfg, 0, device="cpu")))
    # the instrumented collective API once at gradient volume, so the
    # metrics carry a measured entry of that size
    C.all_reduce(torch.zeros(n_params // 64, device=dev))
    coll = {k: v for k, v in metrics.snapshot().items()
            if k.startswith("collective_")}
    return dict(rank=rank, overlap_ms=overlap_ms, lockstep_ms=lockstep_ms,
                loss=loss_o, loss_lockstep=loss_l, n_params=n_params,
                itemsize=torch.finfo(cfg.dtype).bits // 8,
                events_overlap=events_o,
                events_lockstep=events[len(events_o):],
                sidecar=sidecar, collective_metrics=coll,
                device=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"))


def multichip(device=None, trace_out=None, timeout=600.0):
    """The ``--multichip`` result dict (see the module docstring)."""
    from .distributed import overlap as ov
    from .distributed.launch import spawn
    from .profiler import trace
    dev = resolve_device(device)
    dp, pp = MULTICHIP_PLAN["dp"], MULTICHIP_PLAN["pp"]
    n_micro = MULTICHIP_MICRO
    B, S = MULTICHIP_SHAPE
    ranks = spawn(_multichip_rank, 8, (dev.type, trace_out),
                  device=dev.type, backend="gloo", timeout=timeout)
    r0 = ranks[0]
    ev_o = ov.schedule_events(pp, n_micro, overlap=True)
    ev_l = ov.schedule_events(pp, n_micro, overlap=False)
    st_o, st_l = ov.transfer_stats(ev_o), ov.transfer_stats(ev_l)
    cfg = MULTICHIP_MODEL_CARD if dev.type == "cuda" else MULTICHIP_MODEL
    edge_bytes = (B // dp // n_micro) * S * cfg["hidden_size"] \
        * r0["itemsize"]
    result = {
        "metric": "llama_train_multichip_step",
        "value": round(r0["overlap_ms"], 2),
        "unit": "ms_per_step",
        "vs_baseline": round(r0["lockstep_ms"] / r0["overlap_ms"], 3),
        "detail": {
            "plan": dict(MULTICHIP_PLAN, schedule="1f1b",
                         n_microbatches=n_micro, overlap=True),
            "devices": 8, "device": r0["device"],
            "gpu": gpu_line() if dev.type == "cuda" else None,
            "transport": "gloo" + (" (point-to-point through host "
                                   "memory)" if dev.type == "cuda" else ""),
            "batch": B, "seq": S,
            "step_ms_overlap": round(r0["overlap_ms"], 2),
            "step_ms_lockstep": round(r0["lockstep_ms"], 2),
            "loss": round(r0["loss"], 6),
            "loss_lockstep": round(r0["loss_lockstep"], 6),
            "overlap": {
                "overlap_fraction": round(ov.overlap_fraction(ev_o), 3),
                "overlap_fraction_lockstep":
                    round(ov.overlap_fraction(ev_l), 3),
                "serialized_transfers": st_o["serialized_transfers"],
                "serialized_transfers_lockstep":
                    st_l["serialized_transfers"],
                "total_transfers": st_o["total_transfers"],
            },
            "collective_bytes_modeled": {
                "pipeline_p2p_per_step": 2 * n_micro * (pp - 1) * edge_bytes,
                "grad_allreduce_per_step": r0["n_params"] * r0["itemsize"],
            },
            "collective_metrics": r0["collective_metrics"],
        },
    }
    if trace_out:
        meas_o = trace.pipeline_schedule_events(r0["events_overlap"])
        meas_l = trace.pipeline_schedule_events(r0["events_lockstep"])
        result["detail"]["overlap"]["measured"] = {
            "overlap_fraction": round(
                ov.measured_overlap(meas_o)["overlap_fraction"], 3),
            "overlap_fraction_lockstep": round(
                ov.measured_overlap(meas_l)["overlap_fraction"], 3),
            "matches_static": meas_o == ev_o and meas_l == ev_l,
        }
        result["detail"]["trace_sidecar"] = r0["sidecar"]
    if st_o["serialized_transfers"] >= st_l["serialized_transfers"]:
        raise AssertionError("overlap schedule must serialize strictly "
                             "fewer transfers")
    return result


def multichip_gang(nproc, trace_out=None, steps=2, device=None,
                   log_dir=None, timeout=None):
    """The ``--multichip --gang N`` result dict (see the module
    docstring).  Worker logs go to ``log_dir`` (default: a new temporary
    directory)."""
    import tempfile
    dev = resolve_device(device)
    log_dir = log_dir or tempfile.mkdtemp(prefix="bench_gang_")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--max_restarts", "0",
           "--log_dir", log_dir,
           "--module", "paddle_tpu_torch.distributed.gang",
           "--steps", str(steps), "--device", dev.type]
    if trace_out:
        cmd += ["--trace-out", trace_out]
    env = dict(os.environ)
    env.pop("PTQ_CHAOS", None)  # never inherit chaos into a bench pod
    timeout = timeout or float(os.environ.get(
        "PADDLE_TPU_BENCH_TIMEOUT", "1000"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.monotonic()
    proc = subprocess.run(cmd, env=env, cwd=repo, timeout=timeout,
                          capture_output=True, text=True)
    wall_s = time.monotonic() - t0
    results = {}
    for rank in range(nproc):
        path = os.path.join(log_dir, f"workerlog.{rank}")
        try:
            with open(path) as f:
                for ln in f:
                    if ln.startswith("GANG_RESULT "):
                        r = json.loads(ln[len("GANG_RESULT "):])
                        results[r["rank"]] = r
        except OSError:
            pass
    if proc.returncode != 0 or len(results) != nproc:
        tail = (proc.stderr or proc.stdout or "")[-800:]
        raise RuntimeError(
            f"gang pod failed: rc={proc.returncode}, "
            f"{len(results)}/{nproc} GANG_RESULT lines "
            f"(logs: {log_dir})\n{tail}")
    r0 = results[0]
    losses0 = r0["losses"]
    for rank, r in sorted(results.items()):
        if r["losses"] != losses0:
            raise RuntimeError(
                f"rank {rank} loss trajectory diverged from rank 0: "
                f"{r['losses']} != {losses0}")
    # None = tracing off for that rank; False = recorded schedule
    # diverged from the static model — a hard failure
    matches = [r["matches_static"] for _, r in sorted(results.items())]
    if any(m is False for m in matches):
        raise RuntimeError(
            f"recorded 1F1B schedule diverged from static model: "
            f"per-rank matches_static={matches}")
    step_ms = max(r["step_ms"] for r in results.values())
    return {
        "metric": "llama_train_multichip_step",
        "value": round(step_ms, 2),
        "unit": "ms_per_step",
        "vs_baseline": None,  # no lockstep twin run in gang mode
        "detail": {
            "real_processes": nproc,
            "plan": {"dims": r0["plan"], "schedule": r0["schedule"],
                     "n_microbatches": r0["n_microbatches"],
                     "overlap": r0["overlap"]},
            "world_size": r0["world_size"],
            "steps": r0["steps"],
            "loss": losses0[-1] if losses0 else None,
            "losses": losses0,
            "step_ms_per_rank": {str(rank): r["step_ms"]
                                 for rank, r in sorted(results.items())},
            "matches_static": matches,
            "pod_wall_s": round(wall_s, 2),
            "log_dir": log_dir,
            "device": r0.get("device"),
            "gpu": gpu_line() if dev.type == "cuda" else None,
            "transport": ("nccl" if dev.type == "cuda"
                          and nproc <= torch.cuda.device_count()
                          else "gloo"),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "bench.py's CPU smoke shape)")
    ap.add_argument("--multichip", action="store_true",
                    help="dp=2 x pp=2 x mp=2 1F1B, overlapped against "
                         "lockstep, as 8 ranks over gloo")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="with --multichip: the flight recorder on, one "
                         "sidecar a rank in DIR")
    ap.add_argument("--gang", type=int, default=None, metavar="N",
                    help="with --multichip: the gang preset (pp=N 1F1B) "
                         "as N real processes through the launcher")
    ap.add_argument("--steps", type=int, default=2,
                    help="with --gang: train steps")
    args = ap.parse_args(argv)
    if args.gang is not None and not args.multichip:
        ap.error("--gang needs --multichip")
    metric = ("llama_train_multichip_step" if args.multichip
              else "llama_train_mfu_1card")
    try:
        if args.multichip and args.gang:
            result = multichip_gang(args.gang, args.trace_out, args.steps,
                                    args.device)
            ok = all(math.isfinite(x) for x in result["detail"]["losses"])
        elif args.multichip:
            result = multichip(args.device, args.trace_out)
            ok = all(math.isfinite(result["detail"][k])
                     for k in ("loss", "loss_lockstep"))
        else:
            result = measure(args.device)
            ok = all(math.isfinite(x) for x in (result["loss_step0"],
                                                 result["loss_last"]))
        if not ok:
            result["error"] = "non-finite loss"
    except BaseException as exc:  # noqa: BLE001 - the line must print
        result = {"metric": metric, "value": None,
                  "unit": ("ms_per_step" if args.multichip
                           else "percent_mfu"),
                  "error": f"{type(exc).__name__}: {exc}"[-2000:]}
        ok = False
        if not isinstance(exc, Exception):
            print(json.dumps(result), flush=True)
            raise
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
