"""Exact-arithmetic gang worker of the port, for the multi-process E2E
tests (the counterpart of ``tests/gang_e2e_worker.py``; imports no JAX).

Trains a tiny linear model under the port's gang runtime
(``paddle_tpu_torch.distributed.gang``) with every floating-point
operation EXACT: integer data in {-1, 0, 1}, float64 weights quantized
to the 2^-12 dyadic grid each step, a power-of-two global batch and
learning rate.  Each rank takes its block of the global batch, and the
gradient and loss are summed over the world; every intermediate is a
dyadic rational well inside float64's mantissa, so the sums are
order-independent and the loss trajectory is bit-identical at ANY world
size.

Per completed step the worker prints one line::

    E2E_STEP {"restart": R, "rank": k, "world": W, "step": n,
              "loss": <float64 repr>, "ids": [global sample ids], "t": wall}

and on clean completion ``E2E_DONE {"rank": k, "restart": R}``.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GRID = 4096.0    # 2^12 quantization grid for the weights
LR = 2.0 ** -6
DIM = 4


def make_batch(step: int, batch: int):
    """Deterministic integer batch for 1-based ``step``: global sample
    ids and features/targets in {-1, 0, 1} derived from them (the
    reference worker's)."""
    import numpy as np
    ids = np.arange((step - 1) * batch, step * batch, dtype=np.int64)
    x = np.stack([((ids * (k + 2) + k) % 3) - 1 for k in range(DIM)],
                 axis=1).astype(np.float64)
    y = ((ids % 3) - 1).astype(np.float64)
    return ids, x, y


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ckpt-root", required=True)
    args = p.parse_args()

    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import gang
    from paddle_tpu_torch.distributed.reshard import restore_resharded

    ctx = gang.init_gang(gang.GangConfig.from_env(
        ckpt_root=args.ckpt_root), device="cpu")
    W, r = ctx.world_size, ctx.rank
    per = args.batch // W

    state, start = restore_resharded(args.ckpt_root, device="cpu")
    if state is None:
        w = torch.zeros(DIM, dtype=torch.float64)
    else:
        w = state["params"]["w"].to(torch.float64)

    with ctx.running():
        for step in range(start + 1, args.steps + 1):
            ids, x, y = make_batch(step, args.batch)
            xs = torch.from_numpy(x[r * per:(r + 1) * per])
            ys = torch.from_numpy(y[r * per:(r + 1) * per])
            res = xs @ w - ys
            acc = torch.cat([(2.0 * res) @ xs, (res @ res).reshape(1)])
            C.all_reduce(acc)            # sums over the world: exact
            g, loss = acc[:DIM] / args.batch, acc[DIM] / args.batch
            # requantize to the dyadic grid: the pre-rounding value is
            # exact (order-independent), so the rounded weights are
            # identical at every world size and across save/restore
            w = torch.round((w - LR * g) * GRID) / GRID
            print("E2E_STEP " + json.dumps({
                "restart": ctx.restart, "rank": r, "world": W,
                "step": step, "loss": float(loss), "ids": ids.tolist(),
                "t": time.time()}, sort_keys=True), flush=True)
            # the gang step boundary: health step stamp, final-save
            # snapshot handover, and the collective.all_reduce chaos
            # injection point the kill/hang E2Es target
            ctx.step_boundary(step, {"w": w}, {"step": step})

    print("E2E_DONE " + json.dumps(
        {"rank": r, "restart": ctx.restart}), flush=True)
    ctx.shutdown(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
