"""The port's distributed runtime on the CPU: the topology, the
collectives against numpy, the collectives a train step runs under each
remat policy and the fused-block routing under tensor parallelism, the
store, the plan (mirroring ``tests/test_plan.py``'s validation,
``for_world_size`` and spec round-trip tests) and ``run_train_loop``
against the reference's.

Spawned ranks run ``tests/torch_dist_workers.py`` (torch and the port
only) over gloo, each world under its own timeout.  Tolerances:
collectives on float32 data atol 1e-5 against numpy's float64 results;
on bfloat16 data, what only moves values is exact, and what sums n of
them is within n * 2**-8 (bfloat16's unit roundoff, once for each
addition and the last rounding) of the same sum over the magnitudes;
``run_train_loop`` losses atol 2e-5 against JAX's (float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from paddle_tpu.distributed.plan import Plan as JPlan
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import HybridTopology, ONE_RANK, TCPStore
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import overlap
from paddle_tpu_torch.distributed.plan import Plan, PlanError
from paddle_tpu_torch.distributed.tensor_parallel import TensorParallel
from paddle_tpu_torch.distributed.zero import zero_shard_dim
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.runtime import watchdog

FIELDS = dict(jllama.PRESETS["llama-debug"])
TIMEOUT = 300.0
COORDS = np.arange(4).reshape(2, 1, 1, 1, 2)   # dp=2 x mp=2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jparams():
    cfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                             **FIELDS)
    return cfg, _np(jllama.init_params(cfg, jax.random.PRNGKey(0)))


def _batch(rng, B=8, S=32):
    V = FIELDS["vocab_size"]
    return {"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32)}


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

def test_world_of_one_topology_needs_no_process_group():
    topo = HybridTopology()
    assert topo.dims == {"dp": 1, "pp": 1, "sharding": 1, "sp": 1, "mp": 1}
    assert topo.coords == {a: 0 for a in topo.AXES}
    assert topo.batch_axes == "dp" and topo.world_size() == 1
    for axis in ("dp", "mp", ("dp", "sharding")):
        assert topo.group(axis) is ONE_RANK
    x = torch.arange(6.0)
    assert C._all_reduce(x, group=topo.group("dp")) is x
    assert C._all_gather(x, ONE_RANK) is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        HybridTopology(mp=2)


def test_pipeline_and_context_parallel_topologies_raise():
    """pp and sp are ported: a world of one cannot hold two stages or two
    sequence blocks, and the pipeline needs a pipelined step."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        HybridTopology(pp=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        HybridTopology(sp=2)
    topo = HybridTopology()
    assert (topo.pp_degree, topo.sp_degree) == (1, 1)
    assert topo.sequence_block(8) == range(0, 8)
    assert topo.group("pp") is ONE_RANK and topo.group("sp") is ONE_RANK


# ---------------------------------------------------------------------------
# collectives against numpy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collectives():
    return spawn(workers.collectives_vs_numpy, 4, (11,), device="cpu",
                 timeout=TIMEOUT)


def _members(axis):
    """Each rank's group under ``axis`` in group-rank order."""
    if axis == "world":
        return {r: list(range(4)) for r in range(4)}
    i = {"dp": 0, "mp": 4}[axis]
    rows = np.moveaxis(COORDS, i, -1).reshape(-1, 2)
    return {int(r): [int(x) for x in row] for row in rows for r in row}


def _expected(xs, op, axis, me):
    grp = _members(axis)[me]
    n, k = len(grp), grp.index(me)
    stack = np.stack([xs[r].astype(np.float64) for r in grp])
    if op in ("sum", "max", "min", "avg"):
        return {"sum": stack.sum(0), "max": stack.max(0),
                "min": stack.min(0), "avg": stack.mean(0)}[op]
    kind, *arg = op.split("/")
    if kind == "all_gather":
        return np.concatenate(list(stack), axis=int(arg[0]))
    if kind == "reduce_scatter":
        return np.split(stack.sum(0), n, axis=int(arg[0]))[k]
    if kind == "broadcast":
        return stack[int(arg[0])]
    if kind == "all_to_all":
        return np.concatenate([np.split(s, n)[k] for s in stack])
    raise AssertionError(op)


def test_rank_coordinates_follow_the_reference_reshape(collectives):
    for r, res in enumerate(collectives):
        assert res["rank"] == r
        want = np.argwhere(COORDS == r)[0]
        assert [res["coords"][a] for a in HybridTopology.AXES] == list(want)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_collectives_match_numpy(collectives, dtype):
    xs = {r: res[dtype]["x"] for r, res in enumerate(collectives)}
    mags = {r: np.abs(x) for r, x in xs.items()}
    checked = 0
    for me, res in enumerate(collectives):
        for key, got in res[dtype].items():
            if key == "x":
                continue
            kind, *rest = key.split("/")
            axis = rest[-1]
            op = rest[0] if kind == "all_reduce" else (
                "sum" if kind == "all_reduce_async" else
                "/".join([kind] + rest[:-1]))
            want = _expected(xs, op, axis, me)
            if dtype == "torch.float32":
                tol = 1e-5
            elif op in ("sum", "avg") or kind == "reduce_scatter":
                tol = (len(_members(axis)[me]) * 2.0 ** -8
                       * _expected(mags, op, axis, me))
            else:
                tol = 0.0
            assert (np.abs(got - want) <= tol).all(), key
            checked += 1
    assert checked == 4 * 3 * 11


# ---------------------------------------------------------------------------
# a step's collectives under each remat policy; the fused-block routing
# ---------------------------------------------------------------------------

def test_collectives_per_step_under_each_remat_policy():
    """dp=2 x mp=2, L = 2 layers, sequence parallel.  A step's
    collectives: each layer's forward all-gathers twice (into the
    attention and the MLP products) and reduce-scatters twice (out of
    them), its backward the reverse; the embedding's vocab-parallel
    lookup reduce-scatters (its backward all-gathers), the final norm's
    output is all-gathered (reduce-scattered back); the cross-entropy
    all-reduces its max, its sum and its target logit; the gradients of
    the three norms' weights (whole on every mp rank) are all-reduced
    over mp; ZeRO over dp reduce-scatters and all-gathers each of the 12
    leaves; the loss is averaged over dp.  Under "full" and "dots" the
    backward recomputes each layer's forward up to the last tensor it
    needs: its two all-gathers and the attention's reduce-scatter (the
    MLP's comes after everything the backward reads).  The fused blocks
    ("on") never engage under tensor parallelism."""
    cfg, np_params = _jparams()
    batch = _batch(np.random.default_rng(3))
    out = spawn(workers.collective_counts, 4,
                (FIELDS, np_params, batch, [None, "full", "dots"]),
                device="cpu", timeout=TIMEOUT)
    L, leaves = FIELDS["num_hidden_layers"], 12
    base = {"all_gather": 4 * L + 2 + leaves,
            "reduce_scatter": 4 * L + 2 + leaves,
            "all_reduce": 3 + 3 + 1}
    remat = dict(base, all_gather=base["all_gather"] + 2 * L,
                 reduce_scatter=base["reduce_scatter"] + L)
    for r in out:
        assert r["None"]["calls"] == base
        assert r["full"]["calls"] == remat
        assert r["dots"]["calls"] == remat
        assert r["None"]["loss"] == r["full"]["loss"] == r["dots"]["loss"]
        assert r["fused_entered"] == 0


def test_fused_blocks_engage_only_on_a_whole_layer():
    cfg = tllama.LlamaConfig(dtype=torch.float32, vocab_size=256,
                             hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=2,
                             num_key_value_heads=2, fused_blocks="on")
    x = torch.zeros(1, 4, 256)
    assert tllama._fused_block_modes(cfg, x) == (True, True)
    tp = TensorParallel(None, 2, 0, True)
    assert tllama._fused_block_modes(cfg, x, tp) == (False, False)


# ---------------------------------------------------------------------------
# ZeRO's shard choice, the tail buckets
# ---------------------------------------------------------------------------

def test_zero_shard_dim_is_the_references_choice():
    # largest dim not split by mp, lower index on a tie, divisible
    assert zero_shard_dim(("pp", None, "mp"), (2, 64, 64), "dp", 4) == 1
    assert zero_shard_dim(("mp", None), (256, 64), "dp", 2) == 1
    assert zero_shard_dim((None, "mp"), (64, 256), "dp", 2) == 0
    assert zero_shard_dim((None,), (64,), "sharding", 2) == 0
    assert zero_shard_dim(("pp", None), (2, 6), "dp", 4) is None
    assert zero_shard_dim(("pp", None, None), (8, 6, 6), "dp", 4) is None
    assert zero_shard_dim(("dp", None), (8, 8), "dp", 2) is None


def test_bucketed_psum_buckets_in_sorted_leaf_order(monkeypatch):
    sizes = []
    monkeypatch.setattr(C, "_all_reduce",
                        lambda t, group=None: sizes.append(t.numel()) or t)
    tree = {"norm_f": torch.ones(64), "embed": torch.ones(4 << 18),
            "lm_head": torch.full((3, 5), 2.0), "zz": {"a": torch.ones(7)}}
    out = overlap.bucketed_psum(tree, group=None, bucket_bytes=4 << 20)
    # embed (4 MiB of f32) fills a bucket; lm_head, norm_f and zz/a share
    # the next
    assert sizes == [4 << 18, 15 + 64 + 7]
    for k in ("norm_f", "embed", "lm_head"):
        assert torch.equal(out[k], tree[k])
    assert torch.equal(out["zz"]["a"], tree["zz"]["a"])


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_values_objects_and_wait_timeout():
    master = TCPStore("127.0.0.1", 0, True, world_size=1, timeout=5)
    client = TCPStore("127.0.0.1", master.port, False, world_size=1,
                      timeout=5)
    assert client.get("missing") is None
    client.set("k", b"v")
    assert master.get("k") == b"v"
    client.set("obj", {"a": [1, 2]})
    assert master.get_obj("obj") == {"a": [1, 2]}
    assert client.add("n", 2) == 2 and master.add("n", 3) == 5
    assert client.delete_key("k") and master.get("k") is None
    with pytest.raises(TimeoutError, match="never"):
        client.wait("never", timeout=0.2)


def test_store_barrier_names_the_rank_that_never_arrived():
    watchdog.clear_incidents()
    store = TCPStore("127.0.0.1", 0, True, world_size=3, timeout=5)
    other = TCPStore("127.0.0.1", store.port, False, world_size=3,
                     timeout=5)
    other.set("__bar_in__gate/2", b"1")     # rank 2 stamped, never counted
    with pytest.raises(TimeoutError, match=r"ranks \[1\] never arrived"):
        store.barrier("gate", rank=0, timeout=0.3)
    inc = watchdog.last_incident()
    assert inc["kind"] == "store_barrier_timeout" and inc["missing"] == [1]
    assert store.barrier_missing("gate") == [1]
    watchdog.clear_incidents()


def test_store_retries_transient_failures_with_backoff():
    import random
    store = TCPStore("127.0.0.1", 0, True, world_size=1, timeout=5)
    real, fails, sleeps = store._impl, [2], []

    class Flaky:
        def set(self, key, value):
            if fails[0]:
                fails[0] -= 1
                raise ConnectionResetError("dropped")
            real.set(key, value)

    store._impl = Flaky()
    store._sleep = sleeps.append
    store._retry_rng = random.Random(0)
    store.set("k", b"v")
    store._impl = real
    assert store.get("k") == b"v"
    assert len(sleeps) == 2 and 0.05 <= sleeps[0] < sleeps[1] <= 0.125
    store._impl, fails[0] = Flaky(), 9
    with pytest.raises(ConnectionResetError):
        store.set("k", b"w")
    assert len(sleeps) == 2 + 3          # 4 attempts, 3 backoffs


# ---------------------------------------------------------------------------
# the plan (tests/test_plan.py's validation, refit and round trip)
# ---------------------------------------------------------------------------

def test_plan_validates_schedule_and_degrees():
    with pytest.raises(PlanError):
        Plan(schedule="zigzag")
    with pytest.raises(PlanError):
        Plan(schedule="1f1b")
    with pytest.raises(PlanError):
        Plan(dp=0)
    p = Plan(dp=2, pp=2, schedule="1f1b", n_microbatches=4)
    assert p.world_size == 4
    assert p.dims == {"dp": 2, "pp": 2, "sharding": 1, "sp": 1, "mp": 1}


def test_plan_needs_the_process_groups_ranks():
    with pytest.raises(PlanError, match="needs 2 ranks"):
        Plan(dp=2).topology()
    assert Plan().topology().world_size() == 1


def test_for_world_size_keeps_model_axes_when_divisible():
    p = Plan(dp=4, pp=2, schedule="1f1b", n_microbatches=4, overlap=True)
    q = p.for_world_size(4)
    assert (q.dp, q.pp, q.schedule) == (2, 2, "1f1b")
    r = p.for_world_size(3)
    assert (r.dp, r.pp, r.schedule) == (3, 1, "none")
    for n in (2, 3, 4, 8):
        assert JPlan(**{f.name: getattr(p, f.name) for f in
                        p.__dataclass_fields__.values()}).for_world_size(
            n).to_spec() == p.for_world_size(n).to_spec()


def test_plan_spec_roundtrip(tmp_path):
    p = Plan(dp=2, pp=2, mp=2, schedule="1f1b", n_microbatches=4,
             overlap=True, param_specs={"embed": [["mp"], None]})
    q = Plan.from_spec(p.to_spec())
    assert q == p
    path = str(tmp_path / "plan.json")
    p.save(path)
    assert Plan.load(path) == p
    assert Plan.from_report(path) == p
    # byte-compatible with the reference's spec file
    JPlan.from_spec(p.to_spec()).save(str(tmp_path / "ref.json"))
    with open(path) as a, open(tmp_path / "ref.json") as b:
        assert a.read() == b.read()


def test_from_report_topology_section():
    report = {"topology": {"dp": 4, "pp": 2, "sharding": 1, "sp": 1,
                           "mp": 1, "n_microbatches": 2,
                           "zero_axis": "dp"}}
    p = Plan.from_report(report)
    assert (p.dp, p.pp, p.schedule, p.n_microbatches, p.overlap) == \
        (4, 2, "1f1b", 2, True)
    with pytest.raises(PlanError):
        Plan.from_report({"no": "topology"})


def test_unported_plan_paths_raise():
    cfg = tllama.LlamaConfig(dtype=torch.float32, **FIELDS)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Plan().compile(lambda x: x)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Plan().verify_callable(lambda x: x)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Plan().train_step(cfg, verify=True, device="cpu")
    with pytest.raises(ValueError, match="virtual_pp"):
        tllama.build_train_step(cfg, schedule="1f1b", virtual_pp=2,
                                device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        tllama.build_train_step(cfg, schedule="zigzag", device="cpu")


def test_run_train_loop_matches_jax_and_refuses_a_resize():
    jcfg, np_params = _jparams()
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(3)]
    port = spawn(workers.train_loop, 2,
                 (FIELDS, np_params, batches, {"dp": 2}, 1),
                 device="cpu", timeout=TIMEOUT)
    ref = JPlan(dp=2).run_train_loop(jcfg, batches,
                                     devices=jax.devices()[:2],
                                     rng=jax.random.PRNGKey(0),
                                     verify=False)
    for r in port:
        hist = r["history"]
        np.testing.assert_allclose(hist["losses"], ref["losses"],
                                   atol=2e-5, rtol=0)
        assert hist["world_sizes"] == ref["world_sizes"] == [2, 2, 2]
        assert hist["resizes"] == ref["resizes"] == []
        assert r["raised"] and "ckpt_root" in r["raised"]
