"""What the port's ranks run in the distributed tests: functions that
``paddle_tpu_torch.distributed.launch.spawn`` (or ``distributed.spawn``)
calls in fresh processes.  This module imports torch, numpy and the
port only (never JAX), so a spawned rank never loads JAX; the test files that hold the ranks' results
against the JAX reference import it."""
import os

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
                r[f"all_reduce/{op}/{tag}"] = C._all_reduce(
                    x.clone(), op=op, group=g).float().numpy()
            r[f"all_gather/0/{tag}"] = C._all_gather(x, g).float().numpy()
            r[f"all_gather/1/{tag}"] = C._all_gather(x, g, dim=1).float(
            ).numpy()
            r[f"reduce_scatter/0/{tag}"] = C._reduce_scatter(
                x, group=g).float().numpy()
            r[f"reduce_scatter/1/{tag}"] = C._reduce_scatter(
                x, group=g, dim=1).float().numpy()
            r[f"broadcast/1/{tag}"] = C._broadcast(
                x.clone(), src=1, group=g).float().numpy()
            r[f"all_to_all/{tag}"] = C._all_to_all(x, group=g).float(
            ).numpy()
            work = C._all_reduce(y := x.clone(), group=g, async_op=True)
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


def ernie_steps(fields, np_params, batches, cases):
    """ERNIE's pretrain step (``models.ernie.build_pretrain_step``) over
    ``init_mesh(**topo_kw)`` for each topology of ``cases``, in turn in
    this world, from the full ``np_params``: each global batch cut by
    ``step.shard_batch``; by case, this rank's metrics a step (the
    global batch's values), its coordinates and the bytes of its
    weights and optimizer state."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.models import ernie as ternie
    cfg = ternie.ErnieConfig(**fields)
    out = []
    for topo_kw in cases:
        topo = init_mesh(**topo_kw)
        step, init = ternie.build_pretrain_step(cfg, topo, device="cpu")
        params, opt = init(params=ternie.shard_params(cfg, np_params, topo,
                                                      device="cpu"))
        res = []
        for b in batches:
            params, opt, m = step(params, opt, step.shard_batch(
                {k: torch.from_numpy(v) for k, v in b.items()}))
            res.append({k: v.item() for k, v in m.items()})
        out.append({"metrics": res, "coords": topo.coords,
                    "weight_bytes": sum(t.numel() * t.element_size() for t
                                        in tllama._paths(params).values()),
                    "state_bytes": opt.state_bytes()})
    return out


# ---------------------------------------------------------------------------
# the eager distributed API (tests/test_torch_dist_api.py,
# tests/test_torch_fleet_mp.py)
# ---------------------------------------------------------------------------

def _np_out(t):
    return t.numpy().copy()


def api_collectives(seed):
    """Every facade collective over a 2-rank world on float32 data from
    ``default_rng(seed + rank)``, the launcher's environment and the
    group queries; returns what the test recomputes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    paddle.set_device("cpu")
    env = dist.init_parallel_env()
    rank = dist.get_rank()
    rng = np.random.default_rng(seed + rank)
    x_np = rng.standard_normal((4, 3)).astype(np.float32)

    def x():
        return paddle.to_tensor(x_np)
    r = {"rank": rank, "world": dist.get_world_size(), "x": x_np,
         "env": (env.rank, env.world_size, env.nranks),
         "trainer_id": os.environ.get("PADDLE_TRAINER_ID"),
         "backend": dist.get_backend(),
         "initialized": dist.is_initialized()}
    for op in ("SUM", "MAX", "MIN", "AVG", "PROD"):
        t = x()
        out = dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        assert out is t
        r[f"all_reduce/{op}"] = _np_out(t)
    parts = []
    dist.all_gather(parts, x())
    r["all_gather/list"] = [_np_out(p) for p in parts]
    r["all_gather/stacked"] = _np_out(dist.all_gather(x()))
    r["broadcast/1"] = _np_out(dist.broadcast(x(), src=1))
    r["reduce/0"] = _np_out(dist.reduce(x(), dst=0))
    t = paddle.zeros([2, 3])
    dist.reduce_scatter(t, [paddle.to_tensor(x_np[:2]),
                            paddle.to_tensor(x_np[2:])])
    r["reduce_scatter/list"] = _np_out(t)
    r["reduce_scatter/traced"] = _np_out(dist.reduce_scatter(x()))
    outs = []
    dist.alltoall([paddle.to_tensor(x_np[:2]), paddle.to_tensor(x_np[2:])],
                  outs)
    r["alltoall/list"] = [_np_out(o) for o in outs]
    r["alltoall/traced"] = _np_out(dist.alltoall(paddle.to_tensor(
        x_np[:2])))
    splits = [1, 3] if rank == 0 else [2, 2]
    r["alltoall_single"] = _np_out(dist.alltoall_single(
        x(), in_split_sizes=splits))
    # only src passes the list, as in Paddle
    t = paddle.zeros([4, 3])
    dist.scatter(t, [paddle.full([4, 3], 10.0), paddle.full([4, 3], 20.0)]
                 if rank == 1 else None, src=1)
    r["scatter/list"] = _np_out(t)
    # src without a list: the blocks of its own tensor
    mine = (paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(4, 3))
            if rank == 0 else paddle.zeros([2, 3]))
    r["scatter/traced"] = _np_out(dist.scatter(mine, src=0))
    # point to point: 0 -> 1 blocking, 1 -> 0 through tasks
    buf = paddle.zeros([4, 3])
    if rank == 0:
        dist.send(x(), dst=1)
        task = dist.irecv(buf, src=1)
    else:
        dist.recv(buf, src=0)
        r["recv_blocking"] = _np_out(buf)
        task = dist.isend(x(), dst=0)
    task.wait()
    if rank == 0:
        r["recv_task"] = _np_out(buf)
    t = x()
    dist.all_reduce(t, sync_op=False).wait()
    r["all_reduce/async"] = _np_out(t)
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    r["all_gather_object"] = objs
    lst = [f"from {rank}", rank * 10]
    dist.broadcast_object_list(lst, src=1)
    r["broadcast_object_list"] = lst
    got = []
    dist.scatter_object_list(got, [f"part0 of {rank}", f"part1 of {rank}"],
                             src=0)
    r["scatter_object_list"] = got
    # groups: every rank creates each, members or not
    solo = dist.new_group([1])
    both = dist.new_group([0, 1])
    r["groups"] = dict(solo_rank=dist.get_rank(solo), solo_size=
                       dist.get_world_size(solo), both_rank=both.rank,
                       both_ranks=both.ranks, gid=both.id,
                       same=dist.get_group(both.id) is both)
    t = x()
    if rank == 1:
        dist.all_reduce(t, group=solo)       # a group of one: identity
    r["solo_all_reduce"] = _np_out(t)
    t = x()
    dist.all_reduce(t, group=both)
    r["both_all_reduce"] = _np_out(t)
    dist.wait(t)
    dist.barrier()
    dist.gloo_barrier()
    return r


def _mlp(paddle, np_params):
    from paddle_tpu_torch import nn
    net = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 3))
    net.set_state_dict(np_params)
    return net


def _ce(paddle, net, xb, yb):
    return paddle.nn.functional.cross_entropy(
        net(paddle.to_tensor(xb)), paddle.to_tensor(yb))


def api_training(np_params, X, Y, lr):
    """``DataParallel`` and ``fleet`` over a 2-rank world: each rank
    takes its half of the rows of ``X``, ``Y``.  One backward through
    ``DataParallel`` (buckets of 100 bytes: several all-reduces), its
    averaged grads and collectives, ``apply_collective_grads`` and
    ``fused_allreduce_gradients`` after it, then an AdamW step; a
    backward under ``no_sync`` averaged by ``apply_collective_grads``;
    ``fleet`` with gradient merge k=2 over SGD, two micro-steps; LocalSGD
    k=2 over SGD on the rank's own rows, through ``distributed_model``
    too; the collectives of each micro-step and step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist, flags
    from paddle_tpu_torch.distributed import fleet
    paddle.set_device("cpu")
    flags.set_flags({"FLAGS_tpu_metrics": True})
    rank = dist.get_rank()
    half = X.shape[0] // 2
    xs, ys = X[rank * half:(rank + 1) * half], Y[rank * half:(rank + 1) * half]
    out = {}
    net = _mlp(paddle, np_params)
    model = dist.DataParallel(net, comm_buffer_size=1e-4,
                              last_comm_buffer_size=1e-4)
    out["state_keys"] = (sorted(model.state_dict()),
                         sorted(net.state_dict()))
    params = net.parameters()
    metrics.reset()
    loss = _ce(paddle, model, xs, ys)
    loss.backward()
    out["calls"], out["bytes"] = _calls(), _calls("bytes")
    out["n_buckets"] = len(model._buckets)
    out["loss"] = loss.item()
    out["grads"] = [p.grad.numpy().copy() for p in params]
    model.apply_collective_grads()
    model.apply_collective_grads()
    dist.fleet.utils.fused_allreduce_gradients(params, None)
    out["grads_after_apply"] = [p.grad.numpy().copy() for p in params]
    out["calls_after_apply"] = _calls()
    opt = paddle.optimizer.AdamW(learning_rate=lr, parameters=params)
    opt.step()
    opt.clear_grad()
    out["adamw"] = [p.numpy().copy() for p in params]
    with model.no_sync():
        _ce(paddle, model, xs, ys).backward()
    out["local_grads"] = [p.grad.numpy().copy() for p in params]
    model.apply_collective_grads()
    out["no_sync_applied"] = [p.grad.numpy().copy() for p in params]
    opt.clear_grad()

    # fleet: dp=2, gradient merge k=2 (avg) over SGD, micro-batches of a
    # quarter of the rows each rank
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    topo = fleet.init(is_collective=True, strategy=strategy)
    out["topo"] = dict(topo.dims)
    gnet = _mlp(paddle, np_params)
    gmodel = fleet.distributed_model(gnet)
    out["wrapped"] = type(gmodel).__name__
    gopt = fleet.distributed_optimizer(paddle.optimizer.SGD(
        learning_rate=lr, parameters=gnet.parameters()))
    out["gm"] = type(gopt).__name__
    snaps, gm_calls = [], []
    q = half // 2
    for m in range(2):
        metrics.reset()
        _ce(paddle, gmodel, xs[m * q:(m + 1) * q],
            ys[m * q:(m + 1) * q]).backward()
        backward = _calls()
        gopt.step()
        gopt.clear_grad()
        gm_calls.append((backward, _calls(), _calls("bytes")))
        snaps.append([p.numpy().copy() for p in gnet.parameters()])
    out["gm_snaps"] = snaps
    out["gm_calls"] = gm_calls
    out["gm_inner_steps"] = gopt.inner_opt._step_count

    # LocalSGD k=2 over SGD: two local steps on this rank's rows, then
    # the parameters averaged over dp
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2}
    strategy.localsgd = True
    strategy.localsgd_configs = {"k_steps": 2}
    fleet.init(is_collective=True, strategy=strategy)
    lnet = _mlp(paddle, np_params)
    lmodel = fleet.distributed_model(lnet)
    out["localsgd_wrapped"] = type(lmodel).__name__
    lopt = fleet.distributed_optimizer(paddle.optimizer.SGD(
        learning_rate=lr, parameters=lnet.parameters()))
    out["localsgd"] = type(lopt).__name__
    lsnaps, lcalls = [], []
    for _ in range(2):
        metrics.reset()
        _ce(paddle, lmodel, xs, ys).backward()
        backward = _calls()
        lopt.step()
        lopt.clear_grad()
        lcalls.append((backward, _calls()))
        lsnaps.append([p.numpy().copy() for p in lnet.parameters()])
    out["localsgd_snaps"] = lsnaps
    out["localsgd_calls"] = lcalls
    return out


def localsgd_round_rank(w0, X, Y, k, lr):
    """``fleet.localsgd.localsgd_round`` on this rank's microbatches
    (``X[rank]``, ``Y[rank]``: k of them) of a linear regression."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.localsgd import localsgd_round
    dist.init_parallel_env()
    rank = dist.get_rank()

    def train_step(params, batch):
        x, y = batch
        w = params["w"].detach().requires_grad_(True)
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        return {"w": (w - lr * g).detach()}, loss.item()

    round_fn = localsgd_round(train_step, k_steps=k)
    params, losses = round_fn({"w": torch.from_numpy(w0)},
                              [(torch.from_numpy(X[rank, i]),
                                torch.from_numpy(Y[rank, i]))
                               for i in range(k)])
    return params["w"].numpy(), losses


def api_world(seed, np_params, X, Y, lr, w0, LX, LY, k):
    """What each rank of ``tests/test_torch_dist_api.py``'s 2-rank world
    runs: ``api_collectives``, ``api_training`` and
    ``localsgd_round_rank``, in turn."""
    torch.set_num_threads(1)
    return {"collectives": api_collectives(seed),
            "training": api_training(np_params, X, Y, lr),
            "localsgd_round": localsgd_round_rank(w0, LX, LY, k, lr)}


def mp_world(full, ids, labels, x, seed):
    """What each rank of ``tests/test_torch_fleet_mp.py``'s 2-rank world
    runs under ``fleet.init`` with mp=2: the tensor-parallel layers from
    the full weights ``full`` (each rank keeps its block) through an
    embedding, a column- and a row-parallel linear, a column projection
    to the vocabulary and the parallel cross-entropy; the other
    ``gather_output`` / ``input_is_parallel`` settings on ``x``; layers
    drawn from ``seed``; ``split``; dropout masks inside and outside the
    RNG tracker.  Returns this rank's blocks (outputs, gradients,
    weights) for the test to put together."""
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    paddle.set_device("cpu")
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    topo = fleet.init(is_collective=True, strategy=strategy)
    rank = topo.coords["mp"]
    V, H = full["emb"].shape
    I = full["w1"].shape[1]

    def block(a, dim):
        n = a.shape[dim] // 2
        return np.take(a, range(rank * n, (rank + 1) * n), axis=dim)

    emb = fleet.VocabParallelEmbedding(V, H)
    col = fleet.ColumnParallelLinear(H, I, gather_output=False)
    row = fleet.RowParallelLinear(I, H, input_is_parallel=True)
    head = fleet.ColumnParallelLinear(H, V, gather_output=False)
    ce = fleet.ParallelCrossEntropy(ignore_index=-100)
    emb.weight.set_value(block(full["emb"], 0))
    col.weight.set_value(block(full["w1"], 1))
    col.bias.set_value(block(full["b1"], 0))
    row.weight.set_value(block(full["w2"], 0))
    row.bias.set_value(full["b2"])
    head.weight.set_value(block(full["w3"], 1))
    head.bias.set_value(block(full["b3"], 0))
    h = emb(paddle.to_tensor(ids))
    logits = head(row(col(h)))
    per = ce(logits, paddle.to_tensor(labels))
    loss = paddle.mean(per)
    loss.backward()
    layers = {"emb": emb, "col": col, "row": row, "head": head}
    out = {"rank": rank, "loss": loss.item(), "per": per.numpy(),
           "logits": logits.numpy(),
           "grads": {f"{n}.{k}": getattr(l, k).grad.numpy()
                     for n, l in layers.items() for k in ("weight", "bias")
                     if getattr(l, k, None) is not None},
           "weight_bytes": sum(p._t.numel() * p._t.element_size()
                               for l in layers.values()
                               for p in l.parameters())}
    # gather_output=True and input_is_parallel=False on whole inputs
    colg = fleet.ColumnParallelLinear(H, I, gather_output=True)
    colg.weight.set_value(block(full["w1"], 1))
    colg.bias.set_value(block(full["b1"], 0))
    rowf = fleet.RowParallelLinear(I, H, input_is_parallel=False)
    rowf.weight.set_value(block(full["w2"], 0))
    rowf.bias.set_value(full["b2"])
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    y = rowf(colg(xt))
    paddle.sum(y * y).backward()
    out["whole"] = y.numpy()
    out["whole_x_grad"] = xt.grad.numpy()
    # drawn from the seed: this rank's blocks of the full draw
    paddle.seed(seed)
    drawn = {"col": fleet.ColumnParallelLinear(H, I).weight.numpy(),
             "row": fleet.RowParallelLinear(I, H).weight.numpy(),
             "emb": fleet.VocabParallelEmbedding(V, H).weight.numpy()}
    paddle.seed(seed)
    drawn["split"] = dist.split(xt, (H, I), "linear", axis=1).numpy()
    out["drawn"] = drawn
    # dropout inside and outside the tracker
    dist.model_parallel_random_seed(seed)
    ones = paddle.ones([64])
    tracker = dist.get_rng_state_tracker()
    with tracker.rng_state():
        inside = paddle.nn.functional.dropout(ones, 0.5).numpy()
    outside = paddle.nn.functional.dropout(ones, 0.5).numpy()
    out["masks"] = (inside, outside)
    return out
