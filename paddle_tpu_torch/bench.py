"""Single-card Llama train-step bench of the port (the counterpart of
``bench.py``'s one-chip MFU bench).  Run from the repository root:

    python -m paddle_tpu_torch.bench                 # on the card
    python -m paddle_tpu_torch.bench --device cpu    # CPU smoke shape

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
    with no mask)."""
    return torch.optim.AdamW(leaves(params), lr=3e-4, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.1)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "bench.py's CPU smoke shape)")
    args = ap.parse_args(argv)
    try:
        result = measure(args.device)
        ok = all(math.isfinite(x) for x in (result["loss_step0"],
                                             result["loss_last"]))
        if not ok:
            result["error"] = "non-finite loss"
    except BaseException as exc:  # noqa: BLE001 - the line must print
        result = {"metric": "llama_train_mfu_1card", "value": None,
                  "unit": "percent_mfu",
                  "error": f"{type(exc).__name__}: {exc}"[-2000:]}
        ok = False
        if not isinstance(exc, Exception):
            print(json.dumps(result), flush=True)
            raise
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
