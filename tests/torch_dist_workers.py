"""What the port's ranks run in the distributed tests: functions that
``paddle_tpu_torch.distributed.spawn`` calls in fresh processes.  This
module imports torch, numpy and the port only (never JAX), so a spawned
rank never loads JAX; the test files that hold the ranks' results
against the JAX reference import it."""
import numpy as np
import torch

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import init_mesh
from paddle_tpu_torch.distributed.plan import Plan, PlanError
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import fused_blocks as fb
from paddle_tpu_torch.profiler import metrics


def _cfg(fields, **kw):
    return tllama.LlamaConfig(dtype=torch.float32,
                              **{"fused_blocks": "off", **fields, **kw})


def _local(params):
    return {k: v.detach().numpy().copy()
            for k, v in tllama._paths(params).items()}


def _calls(what="calls"):
    """The collective calls (or input bytes) by op since
    ``metrics.reset()``."""
    return {k.split('op="')[1].split('"')[0]: v
            for k, v in metrics.snapshot().items()
            if k.startswith(f"collective_{what}_total")}


def sgd1(tensors):
    """SGD at lr 1: a step's update is the gradient itself."""
    return torch.optim.SGD(tensors, lr=1.0)


def train_cases(fields, np_params, batches, cases):
    """Each case ``(topology kwargs, build_train_step kwargs)``, or with
    config overrides and params of its own ``(..., cfg kwargs,
    np_params)``: the train step from ``np_params`` over ``batches``
    (global batches, each cut by ``step.shard_batch``), with this rank's
    losses, the gathered params, its local shards, its optimizer-state
    shapes, its coordinates and the collectives of its first step.
    ``build_train_step`` kwargs name the optimizer ``"sgd1"`` for
    ``sgd1``; such a case takes the first batch only.  With ``plan``
    among them the step is ``Plan(**topology kwargs).train_step``."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import flags
    flags.set_flags({"FLAGS_tpu_metrics": True})
    out = []
    for case in cases:
        topo_kw, step_kw, cfg_kw, case_params = (*case, {}, None)[:4]
        cfg = _cfg(fields, **cfg_kw)
        if case_params is None:
            case_params = np_params
        case_batches = batches
        step_kw = dict(step_kw)
        if step_kw.get("optimizer") == "sgd1":
            step_kw = dict(step_kw, optimizer=sgd1)
            case_batches = batches[:1]
        if step_kw.pop("plan", False):
            step, init = Plan(**topo_kw).train_step(cfg, device="cpu",
                                                    **step_kw)
            topo = step.plan_topology
        else:
            topo = init_mesh(**topo_kw)
            step, init = tllama.build_train_step(cfg, topo, device="cpu",
                                                 **step_kw)
        v = step.virtual_pp
        params, opt = init(params=tllama.shard_params(
            cfg, case_params, topo, device="cpu", virtual_pp=v))
        losses = []
        for i, b in enumerate(case_batches):
            metrics.reset()
            params, opt, m = step(params, opt, step.shard_batch(
                {k: torch.from_numpy(v) for k, v in b.items()}))
            losses.append((m["loss"].item(), m["ce"].item()))
            if i == 0:
                calls, nbytes = _calls(), _calls("bytes")
        out.append({"losses": losses, "coords": topo.coords, "calls": calls,
                    "bytes": nbytes,
                    "reckoned": _moe_reckoning(cfg, topo, b, opt),
                    "params": tllama.gather_params(cfg, params, topo,
                                                   virtual_pp=v),
                    "local": _local(params),
                    "state_shapes": opt.state_shapes(),
                    "overlap": step.overlap})
    return out


def _moe_reckoning(cfg, topo, batch, opt):
    """``chip_smoke.moe_collective_reckoning`` of a data-parallel MoE
    step (None for any other): what the card's check holds its counts
    to, here held to the CPU's."""
    if not cfg.moe_num_experts or topo.world_size() != topo.dp_degree:
        return None
    import chip_smoke
    rows, seq = batch["input_ids"].shape
    return chip_smoke.moe_collective_reckoning(
        cfg, rows // topo.dp_degree, seq, topo.dp_degree, opt)


def collectives_vs_numpy(seed):
    """Every collective over every axis group of a dp=2 x mp=2 world,
    on float32 and bfloat16 data from ``default_rng(seed + rank)``;
    returns the inputs and outputs for the test to recompute."""
    torch.set_num_threads(1)
    topo = init_mesh(dp=2, mp=2)
    rng = np.random.default_rng(seed + topo.rank)
    res = {"coords": topo.coords, "rank": topo.rank}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((4, 8)).astype(
            np.float32)).to(dt)
        r = {"x": x.float().numpy()}
        for axis in ("dp", "mp", None):
            g = topo.group(axis) if axis else None
            tag = axis or "world"
            for op in ("sum", "max", "min", "avg"):
                r[f"all_reduce/{op}/{tag}"] = C.all_reduce(
                    x.clone(), op=op, group=g).float().numpy()
            r[f"all_gather/0/{tag}"] = C.all_gather(x, g).float().numpy()
            r[f"all_gather/1/{tag}"] = C.all_gather(x, g, dim=1).float(
            ).numpy()
            r[f"reduce_scatter/0/{tag}"] = C.reduce_scatter(
                x, group=g).float().numpy()
            r[f"reduce_scatter/1/{tag}"] = C.reduce_scatter(
                x, group=g, dim=1).float().numpy()
            r[f"broadcast/1/{tag}"] = C.broadcast(
                x.clone(), src=1, group=g).float().numpy()
            r[f"all_to_all/{tag}"] = C.all_to_all(x, group=g).float(
            ).numpy()
            work = C.all_reduce(y := x.clone(), group=g, async_op=True)
            work.wait()
            r[f"all_reduce_async/{tag}"] = y.float().numpy()
        C.barrier()
        res[str(dt)] = r
    return res


def collective_counts(fields, np_params, batch, policies):
    """One dp=2 x mp=2 step under each remat policy (None = no remat)
    with metrics on: the collective calls by op, and whether a fused
    block was ever entered (the config asks for them: "on")."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import flags
    flags.set_flags({"FLAGS_tpu_metrics": True})
    entered = []

    def refuse(*a, **k):
        entered.append(1)
        raise AssertionError("a fused block under tensor parallelism")

    fb.fused_attention_block = fb.fused_mlp_block = refuse
    topo = init_mesh(dp=2, mp=2)
    out = {}
    for policy in policies:
        cfg = _cfg(fields, fused_blocks="on", use_remat=policy is not None,
                   remat_policy=policy or "dots")
        step, init = tllama.build_train_step(cfg, topo, device="cpu")
        params, opt = init(params=tllama.shard_params(cfg, np_params, topo,
                                                      device="cpu"))
        metrics.reset()
        _, _, m = step(params, opt, topo.shard_batch(
            {k: torch.from_numpy(v) for k, v in batch.items()}))
        out[str(policy)] = {"calls": _calls(), "loss": m["loss"].item()}
    out["fused_entered"] = len(entered)
    return out


def train_loop(fields, np_params, batches, plan_kw, scale_at):
    """``Plan.run_train_loop`` from ``np_params``; then the same loop
    with a resize requested at step ``scale_at`` and no ``ckpt_root`` to
    reshard through, which must raise ``PlanError``."""
    torch.set_num_threads(1)
    cfg = _cfg(fields)
    plan = Plan(**plan_kw)
    hist = plan.run_train_loop(cfg, [{k: torch.from_numpy(v)
                                      for k, v in b.items()}
                                     for b in batches],
                               params=np_params, device="cpu")

    class Store:
        def __init__(self):
            self.d = {}

        def get(self, k):
            return self.d.get(k)

    store = Store()

    def feed():
        for i, b in enumerate(batches):
            if i == scale_at:
                store.d["elastic/job/world_size"] = b"1"
            yield {k: torch.from_numpy(v) for k, v in b.items()}

    try:
        plan.run_train_loop(cfg, feed(), params=np_params, device="cpu",
                            job_id="job", scale_store=store)
        raised = None
    except PlanError as exc:
        raised = str(exc)
    return {"history": hist, "raised": raised}


def ws1_steps(fields, steps, seed=0):
    """World size 1 through ``Plan().train_step`` on the card (over
    whatever process group ``spawn`` formed) from ``init_params(seed)``:
    the losses, the params and the backend."""
    import torch.distributed as dist
    cfg = tllama.LlamaConfig(dtype=torch.bfloat16, **fields)
    step, init = Plan().train_step(cfg, device="cuda")
    params, opt = init(seed)
    batch = ws1_batch(cfg, "cuda")
    losses = [step(params, opt, batch)[2]["ce"].item() for _ in range(steps)]
    return {"backend": dist.get_backend(), "losses": losses,
            "params": {k: v.detach().cpu()
                       for k, v in tllama._paths(params).items()}}


def ws1_batch(cfg, device, B=2, S=128):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                ).to(device)
            for k in ("input_ids", "labels")}


def close_params(got, ref, steps, lr=3e-4):
    """The gathered params after ``steps`` AdamW steps against the
    reference's: every entry within 2 * lr * steps, at most 0.5 % of
    entries beyond 2e-5 (Adam's first steps are ~sign(g) * lr, so a
    gradient that is ~0 may round to either sign)."""
    flips = total = 0
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        assert d.max() <= 2 * lr * steps, (k, d.max())
        flips += int((d > 2e-5).sum())
        total += d.size
    assert flips <= 0.005 * total, (flips, total)


def _grads_np(tree):
    return {k: v.detach().numpy().copy()
            for k, v in tllama._paths(tree).items()}


def pipeline_cases(fields, np_params, batch, cases):
    """Each case ``(schedule, n_micro, kwargs)`` on a world of pp ranks
    (pp = the world): the pipelined loss and this rank's gradients
    (``1f1b``: ``pipeline_1f1b_value_and_grad``, with the units and sends
    its loop ran; ``gpipe``/``interleaved``: the loss function's
    ``backward()``), from ``np_params`` (float32, no remat, as the
    reference's pipeline tests), or from ``kwargs["params"]`` with the
    config overrides ``kwargs["cfg"]``."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import pipeline as P
    topo = init_mesh(pp=torch.distributed.get_world_size())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for schedule, n_micro, kw in cases:
        v = kw.get("v")
        cfg = _cfg(fields, use_remat=False, **kw.get("cfg", {}))
        params = tllama.shard_params(cfg, kw.get("params", np_params), topo,
                                     device="cpu", virtual_pp=v)
        res = {"stage": topo.coords["pp"]}
        if schedule == "1f1b":
            log = []
            loss, ce, grads = P.pipeline_1f1b_value_and_grad(
                cfg, topo, n_micro, params, tb, overlap=kw["overlap"],
                log=log)
            res.update(log=log, grads=_grads_np(grads))
        else:
            for t in tllama._paths(params).values():
                t.requires_grad_(True)
            if schedule == "gpipe":
                loss, ce = P.pipeline_loss_fn(cfg, topo, n_micro, params, tb)
            else:
                loss, ce = P.pipeline_interleaved_loss_fn(
                    cfg, topo, n_micro, v, params, tb)
            loss.backward()
            res["grads"] = {k: (t.grad.numpy().copy() if t.grad is not None
                                else np.zeros(t.shape, np.float32))
                            for k, t in tllama._paths(params).items()}
        res.update(loss=loss.item(), ce=ce.item())
        out.append(res)
    return out


def attention_cases(inputs, cases):
    """Each case ``(kind, causal, grad)`` on a world of n ranks at sp=n:
    ``ring``/``ulysses``'s sharded wrapper on the global q, k, v of
    ``inputs[i]``, the global output, and with ``grad`` this rank's part
    of the gradients of sum(out ** 2)."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    init_mesh(sp=torch.distributed.get_world_size())
    out = []
    for i, (kind, causal, grad) in enumerate(cases):
        q, k, v = (torch.from_numpy(a).requires_grad_(grad)
                   for a in inputs[i])
        fn = (SP.ring_attention_sharded if kind == "ring"
              else SP.ulysses_attention_sharded)
        o = fn(q, k, v, "sp", causal=causal)
        res = {"out": o.detach().numpy().copy()}
        if grad:
            (o ** 2).sum().backward()
            res["grads"] = [t.grad.numpy().copy() for t in (q, k, v)]
        out.append(res)
    return out


class _CountingStore:
    """The rendezvous store as rank 0's ``run_train_loop`` reads it: each
    read of the scale key, after it returned, bumps ``polls`` in the
    store, so a peer can write a request just after rank 0's read."""

    def __init__(self, store):
        self.store = store

    def get(self, key):
        raw = self.store.get(key)
        self.store.add("polls", 1)
        return raw


def resize_loop(fields, np_params, batches, dp, scale_at, want, ckpt_root,
                between=False, then=()):
    """``Plan(dp=dp).run_train_loop`` from ``np_params`` over the global
    ``batches`` with a resize to ``want`` requested before step
    ``scale_at``: by every rank's feed, or (``between``) by rank 1's
    feed only after rank 0 has read the key for that step.  ``then``:
    further ``(step, want)`` requests, written by every rank still in
    the loop."""
    import time
    from paddle_tpu_torch.distributed.fleet.elastic import request_scale
    from paddle_tpu_torch.distributed.store import current_store
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    store = current_store()

    def feed():
        for i, b in enumerate(batches):
            if i == scale_at and (not between or rank == 1):
                if between:
                    while int(store.get("polls") or 0) < scale_at + 1:
                        time.sleep(0.01)
                request_scale("", "job", want, store=store)
            if i in dict(then):
                request_scale("", "job", dict(then)[i], store=store)
            yield {k: torch.from_numpy(v) for k, v in b.items()}

    hist = Plan(dp=dp).run_train_loop(
        _cfg(fields), feed(), params=np_params, device="cpu", job_id="job",
        scale_store=_CountingStore(store), ckpt_root=ckpt_root)
    return {"rank": rank, **hist}
