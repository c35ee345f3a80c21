"""The port's hybrid-parallel train step against the JAX reference.

``models.llama.build_train_step`` runs as spawned gloo processes on the
CPU (``tests/torch_dist_workers.py``: they import torch and the port
only), the reference's ``build_train_step`` in this process on the
virtual mesh, from the same ``llama-debug``-sized float32 params (JAX's
``init_params``, crossed as numpy and cut by ``shard_params``) over the
same three global batches from ``default_rng``.  Six topologies: dp=2,
mp=2, dp=2 x mp=2, dp=2 x sharding=2 (ZeRO over sharding), dp=4 with
``zero=False``, dp=4 with ``overlap=True``; plus dp=4 with neither, the
yardstick of the overlapped reduction.  The MoE model (4 experts, top 2,
capacity factor 1.0, so that experts overflow) runs at dp=2, dp=2 x
mp=2 and dp=2 x sharding=2 with its experts split over dp, each also
one step under SGD at lr 1, whose update is the global batch's
gradient: held to ``jax.grad`` of the reference's loss on one device
(GSPMD's semantics) at atol 1e-6 + rtol 1e-4, the router's included.

Tolerances, float32: the loss of every step atol 2e-5 (the summation
order of the products, the collectives and the vocab-parallel
cross-entropy differ); the gathered params after three AdamW steps as
``tests/test_torch_llama_train.py`` holds them (every entry within
2 * lr * steps, at most 0.5 % of entries beyond 2e-5: Adam's first
steps are ~sign(g) * lr, so a gradient that is ~0 may round to either
sign).  ZeRO state shapes equal the JAX state leaves' ``shard_shape``;
the ranks of one dp x sharding replica set hold the same bits.  The
overlapped reduction differs from the plain one by the summation order
of the gradient sums only: losses atol 1e-6, params as above.  The
world-size-1 step runs the bench's code and equals it bit for bit.
"""
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from paddle_tpu.distributed.mesh import HybridTopology as JTopology
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(jllama.PRESETS["llama-debug"])
B, S, STEPS, LR = 8, 32, 3, 3e-4
TIMEOUT = 300.0
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)

# name: (ranks, topology, build_train_step kwargs[, config overrides])
TOPOLOGIES = {
    "dp2": (2, dict(dp=2), {}),
    "mp2": (2, dict(mp=2), {}),
    "dp2xmp2": (4, dict(dp=2, mp=2), {}),
    "dp2xsharding2": (4, dict(dp=2, sharding=2), {}),
    "dp4_nozero": (4, dict(dp=4), dict(zero=False)),
    "dp4_overlap": (4, dict(dp=4), dict(overlap=True)),
    "moe_dp2": (2, dict(dp=2), dict(overlap=True), MOE),
    "moe_dp2xmp2": (4, dict(dp=2, mp=2), {}, MOE),
    "moe_dp2xsharding2": (4, dict(dp=2, sharding=2), {}, MOE),
}
YARDSTICK = (4, dict(dp=4), {})   # dp4_overlap without the overlap
MOE_GRADS = [n for n, t in TOPOLOGIES.items() if len(t) > 3]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches():
    rng = np.random.default_rng(7)
    return [{"input_ids": rng.integers(0, FIELDS["vocab_size"], (B, S)
                                       ).astype(np.int32),
             "labels": rng.integers(0, FIELDS["vocab_size"], (B, S)
                                    ).astype(np.int32)}
            for _ in range(STEPS)]


def _jcfg(**kw):
    return jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                              **FIELDS, **kw)


def _jax_run(n, topo_kw, step_kw, batches, cfg_kw=None):
    topo = JTopology(devices=jax.devices()[:n], **topo_kw)
    step, init = jllama.build_train_step(_jcfg(**(cfg_kw or {})), topo,
                                         **step_kw)
    params, state = init(jax.random.PRNGKey(0))
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    mu = tllama._paths(state[0].mu)
    return {"losses": losses, "params": tllama._paths(_np(params)),
            "shard_shapes": {k: tuple(v.sharding.shard_shape(v.shape))
                             for k, v in mu.items()}}


def _jax_grads(np_params, batch):
    """``jax.grad`` of the reference's MoE loss on one device over the
    global batch."""
    grads = jax.grad(lambda p: jllama.loss_fn(_jcfg(**MOE), p, batch)[0])(
        np_params)
    return tllama._paths(_np(grads))


@pytest.fixture(scope="module")
def runs():
    """Both packages on every topology: the port's two worlds (2 and 4
    ranks) start first and run while JAX computes its side."""
    batches = _batches()
    np_params = _np(jllama.init_params(_jcfg(), jax.random.PRNGKey(0)))
    moe_params = _np(jllama.init_params(_jcfg(**MOE),
                                        jax.random.PRNGKey(0)))
    worlds = {}
    for name, (n, topo_kw, step_kw, *cfg_kw) in TOPOLOGIES.items():
        own = (cfg_kw[0], moe_params) if cfg_kw else ()
        worlds.setdefault(n, []).append((name, (topo_kw, step_kw, *own)))
    worlds[4].append(("dp4_plain", YARDSTICK[1:]))
    for name in MOE_GRADS:
        n, topo_kw, step_kw, cfg_kw = TOPOLOGIES[name]
        worlds[n].append((f"{name}_sgd", (topo_kw, dict(
            step_kw, optimizer="sgd1"), cfg_kw, moe_params)))
    with cf.ThreadPoolExecutor(len(worlds)) as pool:
        futs = {n: pool.submit(spawn, workers.train_cases, n,
                               (FIELDS, np_params, batches,
                                [c for _, c in cases]),
                               device="cpu", timeout=TIMEOUT)
                for n, cases in worlds.items()}
        ref = {name: _jax_run(n, topo_kw, step_kw, batches, *cfg_kw)
               for name, (n, topo_kw, step_kw, *cfg_kw)
               in TOPOLOGIES.items()}
        ref_grads = _jax_grads(moe_params, batches[0])
        port = {}
        for n, cases in worlds.items():
            ranks = futs[n].result(timeout=TIMEOUT + 30)
            for i, (name, _) in enumerate(cases):
                port[name] = [r[i] for r in ranks]
    return {"ref": ref, "port": port, "np_params": np_params,
            "moe_params": moe_params, "ref_grads": ref_grads,
            "batches": batches}


def _close_params(got, ref, steps=STEPS):
    flips = total = 0
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        assert d.max() <= 2 * LR * steps, (k, d.max())
        flips += int((d > 2e-5).sum())
        total += d.size
    assert flips <= 0.005 * total, (flips, total)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_step_matches_jax(runs, name):
    ref, ranks = runs["ref"][name], runs["port"][name]
    for r in ranks:
        got = [loss for loss, _ in r["losses"]]
        np.testing.assert_allclose(got, ref["losses"], atol=2e-5, rtol=0)
        _close_params(tllama._paths(r["params"]), ref["params"])
    assert ranks[0]["overlap"] == (name == "dp4_overlap")


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_zero_state_shapes_match_jax(runs, name):
    ref = runs["ref"][name]["shard_shapes"]
    for r in runs["port"][name]:
        assert r["state_shapes"] == {k: (s, s) for k, s in ref.items()}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_dp_replicas_are_bit_identical(runs, name):
    """The ranks that hold the same block of a leaf (the same coordinates
    on the axes it splits over: mp, and dp for an expert leaf) hold the
    same bits."""
    specs = tllama._paths(tllama.param_specs(tllama.LlamaConfig(
        **FIELDS, **(TOPOLOGIES[name][3:] or [{}])[0])))
    for k, spec in specs.items():
        by_block = {}
        for r in runs["port"][name]:
            key = tuple(r["coords"][a] for a in ("dp", "mp") if a in spec)
            by_block.setdefault(key, []).append(r["local"][k])
        for group in by_block.values():
            for other in group[1:]:
                assert np.array_equal(other, group[0]), k


def test_moe_collectives_match_the_chip_reckoning(runs):
    """At dp=2 a MoE step's collective calls and input bytes by op are
    ``chip_smoke.moe_collective_reckoning``'s, which the card's run is
    held to: three forward passes' worth of the layer's collectives
    under "dots" (forward, recompute, backward), ZeRO's and the loss's."""
    for r in runs["port"]["moe_dp2"]:
        assert r["reckoned"] is not None
        assert r["calls"] == r["reckoned"]["calls"]
        assert r["bytes"] == r["reckoned"]["bytes"]


@pytest.mark.parametrize("name", MOE_GRADS)
def test_moe_step_gradients_match_jax_grad(runs, name):
    """One SGD step at lr 1 from the same params: the update is the
    global batch's gradient of ce + 0.01 aux, every leaf (an expert
    leaf's from the tokens of every rank; never summed over dp, which
    would add other experts' gradients to it)."""
    want = runs["ref_grads"]
    p0 = tllama._paths(runs["moe_params"])
    for r in runs["port"][f"{name}_sgd"]:
        got = tllama._paths(r["params"])
        for k, g in want.items():
            np.testing.assert_allclose(p0[k] - got[k], g, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_overlap_differs_from_plain_dp_by_summation_order(runs):
    over, plain = runs["port"]["dp4_overlap"], runs["port"]["dp4_plain"]
    np.testing.assert_allclose([x for x, _ in over[0]["losses"]],
                               [x for x, _ in plain[0]["losses"]],
                               atol=1e-6, rtol=0)
    _close_params(tllama._paths(over[0]["params"]),
                  tllama._paths(plain[0]["params"]))


def test_overlap_reduces_each_layer_inside_the_backward(runs):
    """dp=4, L layers of 9 leaves: with the overlap a step all-reduces
    each layer's 9 slices in the backward, the tail (embed, lm_head,
    norm_f: 129 KiB) in one 4 MiB bucket and the loss; ZeRO then keeps
    this rank's block of the summed gradients and all-gathers the 12
    updated leaves.  Without it: one reduce-scatter a leaf instead."""
    L = FIELDS["num_hidden_layers"]
    for r in runs["port"]["dp4_overlap"]:
        assert r["calls"] == {"all_reduce": 9 * L + 1 + 1,
                              "all_gather": 12}
    for r in runs["port"]["dp4_plain"]:
        assert r["calls"] == {"all_reduce": 1, "reduce_scatter": 12,
                              "all_gather": 12}


def test_world_size_one_step_equals_the_bench_step(runs):
    """No process group: the distributed step runs ``bench.train_step``'s
    code (no collective, the same AdamW over the same leaves) and gives
    the same bits."""
    cfg = tllama.LlamaConfig(dtype=torch.float32, fused_blocks="off",
                             **FIELDS)
    step, init = tllama.build_train_step(cfg, device="cpu")
    assert step.topology.world_size() == 1
    params, opt = init(params=convert.params_from_jax(runs["np_params"],
                                                      device="cpu"))
    ref = convert.params_from_jax(runs["np_params"], device="cpu")
    for t in tbench.leaves(ref):
        t.requires_grad_(True)
    ref_opt = tbench.make_optimizer(ref)
    for b in runs["batches"]:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        params, opt, m = step(params, opt, tb)
        ce = tbench.train_step(cfg, ref, ref_opt, tb)
        assert m["loss"].item() == ce.item() == m["ce"].item()
    got, want = tllama._paths(params), tllama._paths(ref)
    for k in want:
        assert torch.equal(got[k], want[k]), k
