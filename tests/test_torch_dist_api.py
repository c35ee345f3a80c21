"""The port's eager distributed API (``paddle_tpu_torch.distributed``:
the collective facade over ``Tensor``, ``init_parallel_env`` /
``ParallelEnv`` / ``DataParallel``, ``fleet`` with gradient merge,
LocalSGD, LARS and the DGC refusal, ``spawn``) against the JAX
reference on the CPU.

One 2-rank gloo world runs every rank-side check once
(``torch_dist_workers.api_world``, started through the reference's
``spawn(func, args, nprocs, join)`` signature); the oracles run here:

- each collective against the reference's under ``shard_map`` on two
  devices of the virtual CPU mesh with the same per-rank inputs (the
  reference's eager facade is the identity over one process, so a
  world of several ranks has only its traced form to hold against),
  exact; the list forms, point-to-point, objects and groups against
  numpy;
- a world of one (no process group, in this process) against the
  reference's eager identity;
- the ``DataParallel`` step (float32, each rank half the rows) against
  the reference's single-process eager step on the full batch, grads
  and the AdamW update atol 2e-5; its all-reduces a backward equal the
  bucketing's count and bytes;
- gradient merge over dp=2 against the reference's merge of the same
  rows in one process, LocalSGD (through ``distributed_model``) against
  the reference's two local runs averaged, ``localsgd_round`` against
  the reference's under ``shard_map``, atol 1e-5; under either the
  backward reduces nothing, gradient merge reduces once a merged update
  and LocalSGD once a parameter every k-th step.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import torch_dist_workers as workers
import paddle_tpu_torch as paddle
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet

try:
    from jax import shard_map
except ImportError:                      # older jax
    from jax.experimental.shard_map import shard_map

SEED, LR, K = 5, 0.1, 3
TIMEOUT = 120.0


def _inputs():
    rng = np.random.default_rng(0)
    np_params = {
        "0.weight": (rng.standard_normal((6, 8)) * 0.3).astype(np.float32),
        "0.bias": (rng.standard_normal(8) * 0.1).astype(np.float32),
        "2.weight": (rng.standard_normal((8, 3)) * 0.3).astype(np.float32),
        "2.bias": np.zeros(3, np.float32)}
    X = rng.standard_normal((8, 6)).astype(np.float32)
    Y = rng.integers(0, 3, 8)
    LX = rng.standard_normal((2, K, 8, 4)).astype(np.float32)
    LY = rng.standard_normal((2, K, 8, 1)).astype(np.float32)
    w0 = rng.standard_normal((4, 1)).astype(np.float32)
    return np_params, X, Y, LX, LY, w0


@pytest.fixture(scope="module")
def world():
    np_params, X, Y, LX, LY, w0 = _inputs()
    ctx = dist.spawn(workers.api_world,
                     args=(SEED, np_params, X, Y, LR, w0, LX, LY, K),
                     nprocs=2, join=False, device="cpu", timeout=TIMEOUT)
    return {"ranks": ctx.join(), "np_params": np_params, "X": X, "Y": Y,
            "LX": LX, "LY": LY, "w0": w0}


def _xs():
    return [np.random.default_rng(SEED + r).standard_normal((4, 3)).astype(
        np.float32) for r in range(2)]


def _ref(fn, xs, out_spec=P("dp")):
    """``fn`` of a reference Tensor on each of two devices (rank ``r``'s
    input ``xs[r]``), under ``shard_map``; the outputs by rank."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def body(a):
        return fn(jpaddle.Tensor(a, stop_gradient=True))._array

    out = shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=out_spec)(
        jnp.concatenate([jnp.asarray(x) for x in xs]))
    return np.split(np.asarray(out), 2)


# ---------------------------------------------------------------------------
# collectives over two ranks
# ---------------------------------------------------------------------------

def test_env_and_groups(world):
    for rank, r in enumerate(w["collectives"] for w in world["ranks"]):
        assert r["rank"] == rank and r["world"] == 2
        assert r["env"] == (rank, 2, 2) and r["trainer_id"] == str(rank)
        assert r["backend"] == "GLOO" and r["initialized"]
        g = r["groups"]
        assert g["solo_rank"] == (0 if rank == 1 else -1)
        assert g["solo_size"] == 1 and g["both_rank"] == rank
        assert g["both_ranks"] == [0, 1] and g["same"]


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "AVG", "PROD"])
def test_all_reduce_matches_the_reference_under_shard_map(world, op):
    want = _ref(lambda t: jdist.all_reduce(
        t, op=getattr(jdist.ReduceOp, op), group=jdist.Group("dp")), _xs())
    for r, w in zip(world["ranks"], want):
        np.testing.assert_allclose(r["collectives"][f"all_reduce/{op}"], w,
                                   rtol=1e-6, atol=1e-7)


def test_traced_forms_match_the_reference_under_shard_map(world):
    xs, g = _xs(), jdist.Group("dp")
    cases = {
        "all_gather/stacked": (lambda t: jdist.all_gather(t, group=g)),
        "broadcast/1": (lambda t: jdist.broadcast(t, src=1, group=g)),
        "reduce/0": (lambda t: jdist.reduce(t, dst=0, group=g)),
        "reduce_scatter/traced": (lambda t: jdist.reduce_scatter(t,
                                                                 group=g)),
    }
    for name, fn in cases.items():
        for r, w in zip(world["ranks"], _ref(fn, xs)):
            np.testing.assert_allclose(r["collectives"][name], w,
                                       rtol=1e-6, err_msg=name)
    # alltoall of a leading dim of one row a rank
    for r, w in zip(world["ranks"], _ref(
            lambda t: jdist.alltoall(t, group=g), [x[:2] for x in xs])):
        np.testing.assert_array_equal(r["collectives"]["alltoall/traced"],
                                      w)
    # scatter of a replicated tensor: each rank its block of dim 0
    shared = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r, w in zip(world["ranks"], _ref(
            lambda t: jdist.scatter(t, group=g), [shared, shared])):
        np.testing.assert_array_equal(r["collectives"]["scatter/traced"], w)


def test_list_forms_point_to_point_and_objects(world):
    xs = _xs()
    for rank, r in enumerate(w["collectives"] for w in world["ranks"]):
        for i, part in enumerate(r["all_gather/list"]):
            np.testing.assert_array_equal(part, xs[i])
        np.testing.assert_allclose(r["reduce_scatter/list"],
                                   xs[0][2 * rank:2 * rank + 2]
                                   + xs[1][2 * rank:2 * rank + 2],
                                   rtol=1e-6)
        for i, part in enumerate(r["alltoall/list"]):
            np.testing.assert_array_equal(part,
                                          xs[i][2 * rank:2 * rank + 2])
        # rank 0 sends [1 | 3] rows, rank 1 [2 | 2]
        want = (np.concatenate([xs[0][:1], xs[1][:2]]) if rank == 0
                else np.concatenate([xs[0][1:], xs[1][2:]]))
        np.testing.assert_array_equal(r["alltoall_single"], want)
        # scatter from rank 1: its list [10, 20]
        np.testing.assert_array_equal(r["scatter/list"],
                                      np.full((4, 3), (10.0, 20.0)[rank]))
        np.testing.assert_allclose(r["all_reduce/async"], xs[0] + xs[1],
                                   rtol=1e-6)
        assert r["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert r["broadcast_object_list"] == ["from 1", 10]
        assert r["scatter_object_list"] == [f"part{rank} of 0"]
        np.testing.assert_array_equal(r["solo_all_reduce"], xs[rank])
        np.testing.assert_allclose(r["both_all_reduce"], xs[0] + xs[1],
                                   rtol=1e-6)
    ranks = [w["collectives"] for w in world["ranks"]]
    np.testing.assert_array_equal(ranks[1]["recv_blocking"], xs[0])
    np.testing.assert_array_equal(ranks[0]["recv_task"], xs[1])


def test_one_rank_world_is_the_references_eager_identity():
    """No process group: every facade op is the identity, as the
    reference's eager facade over one process."""
    paddle.set_device("cpu")
    x = _xs()[0]
    for op in ("SUM", "MAX", "AVG", "PROD"):
        t, jt = paddle.to_tensor(x), jpaddle.to_tensor(x)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        jdist.all_reduce(jt, op=getattr(jdist.ReduceOp, op))
        np.testing.assert_array_equal(t.numpy(), jt.numpy())
    got, want = [], []
    dist.all_gather(got, paddle.to_tensor(x))
    jdist.all_gather(want, jpaddle.to_tensor(x))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(
        dist.broadcast(paddle.to_tensor(x), src=0).numpy(),
        jdist.broadcast(jpaddle.to_tensor(x), src=0).numpy())
    t, jt = paddle.zeros([4, 3]), jpaddle.zeros([4, 3])
    dist.reduce_scatter(t, [paddle.to_tensor(x)])
    jdist.reduce_scatter(jt, [jpaddle.to_tensor(x)])
    np.testing.assert_array_equal(t.numpy(), jt.numpy())
    t, jt = paddle.zeros([4, 3]), jpaddle.zeros([4, 3])
    dist.scatter(t, [paddle.to_tensor(x)])
    jdist.scatter(jt, [jpaddle.to_tensor(x)])
    np.testing.assert_array_equal(t.numpy(), jt.numpy())
    outs = dist.alltoall([paddle.to_tensor(x)])
    np.testing.assert_array_equal(outs[0].numpy(), x)
    t = paddle.to_tensor(x)
    assert dist.send(t, dst=0) is t and dist.recv(t, src=0) is t
    assert dist.isend(t, 0).wait() and dist.irecv(t, 0).wait()
    objs = []
    assert dist.all_gather_object(objs, 3) == jdist.all_gather_object([], 3)
    assert dist.broadcast_object_list([1, 2]) == [1, 2]
    assert dist.scatter_object_list([], [7, 8]) == \
        jdist.scatter_object_list([], [7, 8])
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    g = dist.new_group()
    assert g.nranks == 1 and g.rank == 0 and dist.get_group(g.id) is g
    assert dist.all_gather(paddle.to_tensor(x)).numpy().shape == (4, 3)


# ---------------------------------------------------------------------------
# DataParallel, fleet, meta-optimizers
# ---------------------------------------------------------------------------

def _jnet(np_params):
    net = jpaddle.nn.Sequential(jpaddle.nn.Linear(6, 8), jpaddle.nn.Tanh(),
                                jpaddle.nn.Linear(8, 3))
    net.set_state_dict(np_params)
    return net


def _jloss(net, X, Y):
    return jpaddle.nn.functional.cross_entropy(
        net(jpaddle.to_tensor(X)), jpaddle.to_tensor(Y))


def test_data_parallel_step_matches_the_references_full_batch(world):
    jnet = _jnet(world["np_params"])
    _jloss(jnet, world["X"], world["Y"]).backward()
    ref_grads = [p.grad.numpy() for p in jnet.parameters()]
    opt = jpaddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jnet.parameters())
    opt.step()
    ref_params = [p.numpy() for p in jnet.parameters()]
    for r in (w["training"] for w in world["ranks"]):
        for g, want in zip(r["grads"], ref_grads):
            np.testing.assert_allclose(g, want, atol=2e-5)
        for p, want in zip(r["adamw"], ref_params):
            np.testing.assert_allclose(p, want, atol=2e-5)
    a, b = (w["training"] for w in world["ranks"])
    for x, y in zip(a["adamw"], b["adamw"]):
        np.testing.assert_array_equal(x, y)


def test_data_parallel_buckets_and_idempotent_apply(world):
    params_bytes = sum(v.nbytes for v in world["np_params"].values())
    for r in (w["training"] for w in world["ranks"]):
        assert r["state_keys"][0] == r["state_keys"][1]
        # one all-reduce a bucket, every gradient byte once
        assert r["n_buckets"] == 4
        assert r["calls"] == {"all_reduce": 4.0}
        assert r["bytes"] == {"all_reduce": float(params_bytes)}
        # apply_collective_grads twice and fused_allreduce_gradients
        # after the hooks: nothing moves, nothing is divided again
        assert r["calls_after_apply"] == r["calls"]
        for g, h in zip(r["grads"], r["grads_after_apply"]):
            np.testing.assert_array_equal(g, h)
    a, b = (w["training"] for w in world["ranks"])
    for la, lb, sa, sb in zip(a["local_grads"], b["local_grads"],
                              a["no_sync_applied"], b["no_sync_applied"]):
        assert not np.array_equal(la, lb)
        np.testing.assert_allclose(sa, (la + lb) / 2, rtol=1e-6, atol=1e-8)
        np.testing.assert_array_equal(sa, sb)


def test_fleet_gradient_merge_matches_the_reference(world):
    from paddle_tpu.distributed import fleet as jfleet
    jnet = _jnet(world["np_params"])
    strategy = jfleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    opt = jfleet.distributed_optimizer(jpaddle.optimizer.SGD(
        learning_rate=LR, parameters=jnet.parameters()), strategy)
    X, Y = world["X"], world["Y"]
    # the global micro-batches: each rank's quarter of its half
    for m in range(2):
        rows = np.r_[2 * m:2 * m + 2, 4 + 2 * m:4 + 2 * m + 2]
        _jloss(jnet, X[rows], Y[rows]).backward()
        opt.step()
        opt.clear_grad()
    want = [p.numpy() for p in jnet.parameters()]
    start = [world["np_params"][k] for k in
             ("0.weight", "0.bias", "2.weight", "2.bias")]
    params_bytes = float(sum(v.nbytes for v in start))
    for r in (w["training"] for w in world["ranks"]):
        assert r["topo"]["dp"] == 2 and r["wrapped"] == "DataParallel"
        assert r["gm"] == "GradientMergeOptimizer"
        assert r["gm_inner_steps"] == 1
        # no backward reduces; the merged update is one bucket's
        # all-reduce of every gradient byte
        (b1, s1, _), (b2, s2, bytes2) = r["gm_calls"]
        assert b1 == s1 == b2 == {}
        assert s2 == {"all_reduce": 1.0}
        assert bytes2 == {"all_reduce": params_bytes}
        for p, s in zip(r["gm_snaps"][0], start):   # after micro-step 1
            np.testing.assert_array_equal(p, s)
        for p, w in zip(r["gm_snaps"][1], want):
            np.testing.assert_allclose(p, w, atol=1e-5)


def test_fleet_localsgd_matches_the_references_local_runs(world):
    X, Y = world["X"], world["Y"]
    local = []
    for rank in range(2):
        jnet = _jnet(world["np_params"])
        opt = jpaddle.optimizer.SGD(learning_rate=LR,
                                    parameters=jnet.parameters())
        rows = slice(4 * rank, 4 * rank + 4)
        for _ in range(2):
            _jloss(jnet, X[rows], Y[rows]).backward()
            opt.step()
            opt.clear_grad()
        local.append([p.numpy() for p in jnet.parameters()])
    for rank, r in enumerate(w["training"] for w in world["ranks"]):
        assert r["localsgd"] == "LocalSGDOptimizer"
        assert r["localsgd_wrapped"] == "DataParallel"
        # the backwards reduce nothing; the 2nd step averages each of
        # the 4 parameters
        (b1, s1), (b2, s2) = r["localsgd_calls"]
        assert b1 == s1 == b2 == {}
        assert s2 == {"all_reduce": 4.0}
        for p, w in zip(r["localsgd_snaps"][0], local[rank]):
            assert not np.allclose(p, w)       # one step in: still local
        for p, a, b in zip(r["localsgd_snaps"][1], *local):
            np.testing.assert_allclose(p, (a + b) / 2, atol=1e-5)


def test_localsgd_round_matches_the_reference_under_shard_map(world):
    from paddle_tpu.distributed.fleet.localsgd import localsgd_round
    LX, LY, w0 = world["LX"], world["LY"], world["w0"]

    def train_step(w, batch):
        x, y = batch
        loss, g = jax.value_and_grad(
            lambda w: jnp.mean((x @ w - y) ** 2))(w)
        return w - LR * g, loss

    round_fn = localsgd_round(train_step, k_steps=K, axis="dp")
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    f = jax.jit(shard_map(lambda w, xb, yb: round_fn(w[0], (xb[0], yb[0])),
                          mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp")),
                          out_specs=(P(), P("dp"))))
    want, _ = f(np.stack([w0, w0]), LX, LY)
    for w, losses in (r["localsgd_round"] for r in world["ranks"]):
        assert len(losses) == K
        np.testing.assert_allclose(w, np.asarray(want), atol=1e-5)


def test_strategy_lars_swaps_momentum_and_dgc_refuses():
    paddle.set_device("cpu")
    w = paddle.nn.Layer().create_parameter([2])
    strat = fleet.DistributedStrategy()
    strat.lars = True
    strat.lars_configs = {"lars_coeff": 0.002, "lars_weight_decay": 0.01,
                          "exclude_from_weight_decay": ["bias"]}
    opt = fleet.distributed_optimizer(paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.8, parameters=[w]), strategy=strat)
    assert isinstance(opt, paddle.optimizer.LarsMomentum)
    assert (opt._lars_coeff, opt._momentum, opt._exclude) == \
        (0.002, 0.8, ["bias"])
    sgd = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    assert fleet.distributed_optimizer(sgd, strategy=strat) is sgd
    strat = fleet.DistributedStrategy()
    strat.dgc = True
    with pytest.raises(NotImplementedError, match="DGC"):
        fleet.distributed_optimizer(sgd, strategy=strat)


def test_gradient_merge_cadence_state_and_static_refusal():
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.fleet.gradient_merge import \
        GradientMergeOptimizer
    from paddle_tpu_torch.distributed.fleet.localsgd import \
        LocalSGDOptimizer
    paddle.set_device("cpu")
    w = paddle.nn.Layer().create_parameter([2])
    gm = GradientMergeOptimizer(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=[w]), k_steps=2)
    paddle.sum(w * w).backward()
    gm.step()
    sd = gm.state_dict()
    assert sd["__gm_step__"] == 0
    gm.set_state_dict(sd)
    assert gm._step_i == 0
    # LocalSGD's average fires every k-th step
    inner = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    opt = LocalSGDOptimizer(inner, k_steps=3)
    syncs = []
    opt._sync_params = lambda: syncs.append(opt._step_i)
    for _ in range(7):
        w.grad = paddle.ones([2])
        opt.step()
    assert syncs == [3, 6]
    paddle.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 2])
            loss = paddle.sum(x)
            opt = GradientMergeOptimizer(paddle.optimizer.SGD(
                learning_rate=0.1), k_steps=2)
            with pytest.raises(NotImplementedError, match="gradient_merge"):
                opt.minimize(loss)
    finally:
        paddle.disable_static()


def test_exports_cover_the_references_eager_api():
    """The names of the reference's ``distributed`` and ``fleet`` the
    port lacks are the next slices' only."""
    later = {"shard_tensor", "shard_op", "shard_layer",
             "with_sharding_constraint", "shard_params", "replicate_params",
             "sharding", "auto_parallel", "ProcessMesh", "PartitionSpec",
             "NamedSharding", "get_mesh", "set_mesh", "rpc",
             "InMemoryDataset", "QueueDataset", "CountFilterEntry",
             "ShowClickEntry", "ProbabilityEntry", "ParallelMode",
             "is_available", "PlanCompilationError",
             "PlanVerificationError"}
    missing = {n for n in jdist.__all__ if not hasattr(dist, n)}
    assert missing == later
    from paddle_tpu.distributed import fleet as jfleet
    assert {n for n in jfleet.__all__ if not hasattr(fleet, n)} == {"auto"}
    assert paddle.DataParallel is dist.DataParallel


def test_io_persistables_round_trip(tmp_path):
    from paddle_tpu_torch import static
    paddle.set_device("cpu")
    paddle.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 2])
            static.nn.fc(x, 3)
        state = main.state_dict()
        assert state and all(dist.io.is_persistable(v)
                             for v in state.values())
        before = {k: v.numpy().copy() for k, v in state.items()}
        dist.io.save_persistables(None, str(tmp_path), main)
        for v in state.values():
            v.set_value(np.zeros(v.shape, np.float32))
        dist.io.load_persistables(None, str(tmp_path), main)
        for k, v in main.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), before[k])
    finally:
        paddle.disable_static()


def test_gloo_bootstrap_and_shutdown_in_a_world_of_one(tmp_path):
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.gloo_init_parallel_env(0, 1, f"127.0.0.1:{port}")
    try:
        assert dist.is_initialized() and dist.get_backend() == "GLOO"
        assert dist.ParallelEnv().world_size == 1
    finally:
        dist.shutdown_process_group()
    assert not dist.is_initialized()
    fs = fleet.utils.LocalFS()
    fs.mkdirs(str(tmp_path / "a" / "b"))
    (tmp_path / "a" / "f").write_text("x")
    assert fs.ls_dir(str(tmp_path / "a")) == (["b"], ["f"])
    fs.delete(str(tmp_path / "a"))
    assert not fs.is_exist(str(tmp_path / "a"))
