"""The port's pipeline schedules against the JAX reference.

``distributed.pipeline`` runs as spawned gloo ranks on the CPU
(``tests/torch_dist_workers.py``), the reference's
``pipeline_1f1b_value_and_grad``, ``pipeline_loss_fn`` and
``pipeline_interleaved_loss_fn`` in this process on the virtual mesh,
from the same float32 params (JAX's ``init_params``, crossed as numpy
and cut by ``shard_params``) and the same ``default_rng`` batch, at the
reference's own test sizes (``tests/test_pipeline_1f1b.py``: 4 layers,
hidden 32, B = 8, S = 16).

Tolerances, as the reference's tests hold its pipelines to the dense
step: losses rtol 1e-5, gradients rtol 5e-4 / atol 1e-5.  1F1B
overlapped equals lockstep bit for bit.  The units and sends the 1F1B
loop runs, gathered from every rank, are ``schedule_events``' events.
``build_train_step`` at dp=2 x pp=2 x mp=2 (1F1B, 8 ranks) and dp=2 x
pp=2 (interleaved, v=2) against the reference's ``build_train_step`` on
one device (the same global batch, the same mean loss) over three AdamW
steps: losses rtol 1e-5, the gathered params as
``tests/test_torch_dist_train.py`` holds them.  The MoE model (4
experts, top 2, capacity factor 1.0) under GPipe, 1F1B and interleaved
at pp=2 against the reference's pipelines on 2 devices (their own aux
scalings; a microbatch's tokens routed together), at the same
tolerances, and its train step at dp=2 x pp=2 (1F1B) against the
reference's ``build_train_step`` on the same 4-device topology, whose
microbatches are slices of the global batch routed over dp; and
``Plan(dp=2, sharding=2, mp=2).train_step`` (the reference's zero+ep
plan) on the MoE model against the reference's step on one device.
(The reference's own 8-device pipelined step aborted the test worker
under the load of a full parallel test run, twice; its pipelines stay
held here on 2 and 4 devices.)  The reference runs first, then the ranks: no rank loads the
host while the reference's collectives run.
"""
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_workers as workers
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.mesh import HybridTopology as JTopology
from paddle_tpu.distributed.overlap import schedule_events
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=64)
B, S, LR, STEPS = 8, 16, 3e-4, 3
TIMEOUT = 300.0

ONE_F_ONE_B = [(pp, nm, ov) for pp, nm in ((2, 4), (4, 8))
               for ov in (False, True)]
# world size 2: every 1F1B case at pp=2, GPipe and interleaved (v=2);
# world size 4: the 1F1B cases at pp=4
CASES = {2: [("1f1b", nm, {"overlap": ov})
             for pp, nm, ov in ONE_F_ONE_B if pp == 2]
         + [("gpipe", 4, {}), ("interleaved", 4, {"v": 2})],
         4: [("1f1b", nm, {"overlap": ov})
             for pp, nm, ov in ONE_F_ONE_B if pp == 4]}
STEP_CASES = {"dp2xpp2xmp2_1f1b": (8, dict(dp=2, pp=2, mp=2),
                                   dict(n_microbatches=4, schedule="1f1b")),
              "dp2xpp2_interleaved": (4, dict(dp=2, pp=2),
                                      dict(n_microbatches=4,
                                           schedule="interleaved")),
              "moe_dp2xpp2_1f1b": (4, dict(dp=2, pp=2),
                                   dict(n_microbatches=4, schedule="1f1b")),
              # the reference's zero+ep plan (tests/test_plan.py:246)
              "moe_zero_ep_plan": (8, dict(dp=2, sharding=2, mp=2),
                                   dict(plan=True))}
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
MOE_PIPES = [("gpipe", 4, {}), ("1f1b", 4, {"overlap": False}),
             ("interleaved", 4, {"v": 2})]


def _jcfg(**kw):
    return jllama.LlamaConfig(dtype=jnp.float32, use_remat=False,
                              fused_blocks="off", **FIELDS, **kw)


def _batch(seed=0, rows=B):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, FIELDS["vocab_size"], (rows, S)).astype(
        np.int32) for k in ("input_ids", "labels")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_moe_pipelines(params, batch):
    """The reference's pipelines on 2 devices for the MoE model."""
    cfg = _jcfg(**MOE)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    out = {}
    loss, ce, grads = jax.jit(lambda p, b: jpipe.pipeline_1f1b_value_and_grad(
        cfg, mesh, 4, p, b))(params, batch)
    out["1f1b"] = (float(loss), float(ce), _np(grads))
    for name, fn in (("gpipe", lambda p: jpipe.pipeline_loss_fn(
            cfg, mesh, 4, p, batch)),
            ("interleaved", lambda p: jpipe.pipeline_interleaved_loss_fn(
                cfg, mesh, 4, 2, p, batch))):
        (loss, ce), grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
        out[name] = (float(loss), float(ce), _np(grads))
    return out


def _jax_pipelines(params, batch):
    out = {}
    for pp, nm, ov in ONE_F_ONE_B:
        mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
        loss, ce, grads = jax.jit(
            lambda p, b: jpipe.pipeline_1f1b_value_and_grad(
                _jcfg(), mesh, nm, p, b, overlap=ov))(params, batch)
        out[("1f1b", pp, nm, ov)] = (float(loss), float(ce), _np(grads))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    for name, fn in (("gpipe", lambda p: jpipe.pipeline_loss_fn(
            _jcfg(), mesh, 4, p, batch)),
            ("interleaved", lambda p: jpipe.pipeline_interleaved_loss_fn(
                _jcfg(), mesh, 4, 2, p, batch))):
        (loss, ce), grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
        out[(name, 2, 4, None)] = (float(loss), float(ce), _np(grads))
    return out


def jax_steps(cfg, np_params, batches, n=1, topo_kw=None, step_kw=None):
    """The reference's ``build_train_step`` from ``np_params`` over
    ``batches``, on one device or on ``n`` with ``topo_kw`` and
    ``step_kw``: its losses and params."""
    topo = JTopology(devices=jax.devices()[:n], **(topo_kw or {}))
    step, init = jllama.build_train_step(cfg, topo, **(step_kw or {}))
    params, state = init(jax.random.PRNGKey(0))
    # the same weights as the port's, in the step's placement
    params = jax.tree_util.tree_map(
        lambda ref, x: jax.device_put(np.asarray(x), ref.sharding),
        params, np_params)
    losses = []
    for b in batches:
        params, state, m = step(params, state, {
            k: jax.device_put(v, NamedSharding(topo.mesh,
                                               P(topo.batch_axes, None)))
            for k, v in b.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": tllama._paths(_np(params))}


@pytest.fixture(scope="module")
def runs():
    np_params = _np(jllama.init_params(_jcfg(), jax.random.PRNGKey(0)))
    moe_params = _np(jllama.init_params(_jcfg(**MOE),
                                        jax.random.PRNGKey(0)))
    batch = _batch()
    batches = [_batch(seed=1 + i, rows=16) for i in range(STEPS)]
    ref = _jax_pipelines(np_params, batch)
    ref_moe = _jax_moe_pipelines(moe_params, batch)
    dense_cfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                                   **FIELDS)
    dense_steps = jax_steps(dense_cfg, np_params, batches)
    ref_steps = {name: dense_steps for name in STEP_CASES
                 if not name.startswith("moe")}
    moe_cfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                                 **FIELDS, **MOE)
    n, topo_kw, step_kw = STEP_CASES["moe_dp2xpp2_1f1b"]
    ref_steps["moe_dp2xpp2_1f1b"] = jax_steps(
        moe_cfg, moe_params, batches, n, topo_kw, step_kw)
    ref_steps["moe_zero_ep_plan"] = jax_steps(moe_cfg, moe_params, batches)
    cases = dict(CASES)
    cases[2] = CASES[2] + [(s, nm, dict(kw, cfg=MOE, params=moe_params))
                           for s, nm, kw in MOE_PIPES]
    step_worlds = {}
    for name, (n, topo_kw, step_kw) in STEP_CASES.items():
        own = (MOE, moe_params) if name.startswith("moe") else ()
        step_worlds.setdefault(n, []).append(
            (name, (topo_kw, step_kw, *own)))
    with cf.ThreadPoolExecutor(4) as pool:
        futs = {n: pool.submit(spawn, workers.pipeline_cases, n,
                               (FIELDS, np_params, batch, c),
                               device="cpu", timeout=TIMEOUT)
                for n, c in cases.items()}
        step_futs = {n: pool.submit(
            spawn, workers.train_cases, n,
            (FIELDS, np_params, batches, [c for _, c in world]),
            device="cpu", timeout=TIMEOUT)
            for n, world in step_worlds.items()}
        port = {}
        for n, c in cases.items():
            ranks = futs[n].result(timeout=TIMEOUT + 30)
            for i, (schedule, nm, kw) in enumerate(c):
                moe = "moe_" if "cfg" in kw else ""
                port[(moe + schedule, n, nm, kw.get("overlap"))] = [
                    r[i] for r in ranks]
        steps = {}
        for n, world in step_worlds.items():
            ranks = step_futs[n].result(timeout=TIMEOUT + 30)
            for i, (name, _) in enumerate(world):
                steps[name] = [r[i] for r in ranks]
    return {"ref": ref, "ref_moe": ref_moe, "port": port,
            "ref_steps": ref_steps, "steps": steps}


def _full_grads(ranks, v=1):
    """The ranks' gradients put together: layers in global order (from
    each stage's block, or chunks under the interleaved layout), the
    tail summed over the stages (1F1B's is summed already: take one)."""
    pp = len(ranks)
    by_stage = sorted(ranks, key=lambda r: r["stage"])
    out = {}
    for k in by_stage[0]["grads"]:
        parts = [r["grads"][k] for r in by_stage]
        if not k.startswith("layers/"):
            out[k] = parts[0] if "log" in ranks[0] else sum(parts)
            continue
        stacked = np.concatenate(parts)
        if v > 1:
            n = stacked.shape[0] // (pp * v)
            rows = [r for g in range(pp * v)
                    for r in range(((g % pp) * v + g // pp) * n,
                                   ((g % pp) * v + g // pp + 1) * n)]
            stacked = stacked[rows]
        out[k] = stacked
    return out


def _check_grads(got, ref):
    for k, r in tllama._paths(ref).items():
        np.testing.assert_allclose(got[k], r, rtol=5e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("pp,n_micro,overlap", ONE_F_ONE_B)
def test_1f1b_matches_jax(runs, pp, n_micro, overlap):
    loss, ce, grads = runs["ref"][("1f1b", pp, n_micro, overlap)]
    ranks = runs["port"][("1f1b", pp, n_micro, overlap)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["ce"], ce, rtol=1e-5)
    _check_grads(_full_grads(ranks), grads)
    # the tail's gradients are the same bits on every stage
    for r in ranks[1:]:
        for k in ("embed", "lm_head", "norm_f"):
            assert np.array_equal(r["grads"][k], ranks[0]["grads"][k]), k


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 8)])
def test_1f1b_overlap_matches_lockstep_bitwise(runs, pp, n_micro):
    lock = runs["port"][("1f1b", pp, n_micro, False)]
    over = runs["port"][("1f1b", pp, n_micro, True)]
    for a, b in zip(lock, over):
        assert a["loss"] == b["loss"]
        for k, g in a["grads"].items():
            assert np.array_equal(g, b["grads"][k]), k


@pytest.mark.parametrize("pp,n_micro,overlap", ONE_F_ONE_B)
def test_1f1b_loop_runs_the_schedule(runs, pp, n_micro, overlap):
    """The forward and backward units the ranks ran, each at its tick,
    are ``schedule_events``' compute events; their sends, its transfer
    events (same schema)."""
    def key(e):   # a total order (the simulator's key ties within a tick)
        return (e["tick"], e.get("stage", e.get("src")), e["kind"],
                e["micro"])

    log = sorted((e for r in runs["port"][("1f1b", pp, n_micro, overlap)]
                  for e in r["log"]), key=key)
    static = sorted(schedule_events(pp, n_micro, overlap=overlap), key=key)

    def compute(evs):
        return [e for e in evs if e["kind"] in ("fwd", "bwd")]

    assert compute(log) == compute(static)
    assert len(compute(log)) == 2 * pp * n_micro
    assert log == static


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_gpipe_and_interleaved_match_jax(runs, schedule):
    loss, ce, grads = runs["ref"][(schedule, 2, 4, None)]
    ranks = runs["port"][(schedule, 2, 4, None)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["ce"], ce, rtol=1e-5)
    _check_grads(_full_grads(ranks, v=2 if schedule == "interleaved"
                             else 1), grads)


@pytest.mark.parametrize("schedule,nm,kw", MOE_PIPES)
def test_moe_pipelines_match_jax(runs, schedule, nm, kw):
    """The MoE model's loss (ce + 0.01 aux, each schedule's aux scaling)
    and gradients at pp=2 against the reference's pipeline."""
    loss, ce, grads = runs["ref_moe"][schedule]
    ranks = runs["port"][("moe_" + schedule, 2, nm, kw.get("overlap"))]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["ce"], ce, rtol=1e-5)
    assert loss != ce
    _check_grads(_full_grads(ranks, v=kw.get("v", 1)), grads)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_jax(runs, name):
    ref = runs["ref_steps"][name]
    ranks = runs["steps"][name]
    for r in ranks:
        np.testing.assert_allclose([x for x, _ in r["losses"]],
                                   ref["losses"], rtol=1e-5)
        workers.close_params(tllama._paths(r["params"]), ref["params"],
                             STEPS, LR)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_tail_replicas_stay_the_same_bits(runs, name):
    """``embed``, ``norm_f`` and ``lm_head`` are whole on every stage:
    after the steps every rank of one mp block holds the same bits."""
    by_mp = {}
    for r in runs["steps"][name]:
        by_mp.setdefault(r["coords"]["mp"], []).append(r["local"])
    for group in by_mp.values():
        for other in group[1:]:
            for k in ("embed", "norm_f", "lm_head"):
                assert np.array_equal(other[k], group[0][k]), k


def test_bench_multichip_line(tmp_path):
    """``python -m paddle_tpu_torch.bench --multichip`` on the CPU: 8
    ranks at dp=2 x pp=2 x mp=2, overlapped 1F1B against lockstep: the
    same loss bits, fewer serialized transfers, and the schedule the
    flight recorder took equal to the static one."""
    from paddle_tpu_torch import bench as tbench
    res = tbench.multichip(device="cpu", trace_out=str(tmp_path))
    d = res["detail"]
    assert d["loss"] == d["loss_lockstep"] and np.isfinite(d["loss"])
    ov = d["overlap"]
    assert ov["serialized_transfers"] < ov["serialized_transfers_lockstep"]
    assert (ov["overlap_fraction"], ov["overlap_fraction_lockstep"]) == \
        (1.0, 0.0)
    assert ov["measured"] == {"overlap_fraction": 1.0,
                              "overlap_fraction_lockstep": 0.0,
                              "matches_static": True}
    assert d["collective_metrics"]['collective_calls_total{op="ppermute"}'] \
        > 0
    assert len(list(tmp_path.glob("trace_rank*.jsonl"))) == 8
