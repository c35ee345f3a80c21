"""The port's context parallelism against the JAX reference.

``distributed.sequence_parallel`` and the context-parallel train step
run as spawned gloo ranks on the CPU (``tests/torch_dist_workers.py``),
the reference in this process on the virtual mesh, on the same inputs
from ``default_rng``:

- ``ring_attention`` at n = 2 and 4 ranks (causal and not, GQA with
  8 heads over 2 kv heads) and ``ulysses_attention`` at n = 2 and 4
  against the reference's ``*_sharded`` wrappers, rtol = atol = 2e-4,
  and the ring's gradients of sum(out ** 2) at rtol = atol = 1e-3, as
  ``tests/test_sequence_parallel.py`` holds the reference;
- ``build_train_step`` context parallel at dp=2 x mp=2 x sp=2 (8
  ranks) and GPipe with ring attention inside at pp=2 x sp=2 (4 ranks),
  three AdamW steps from the same params against the reference's step
  on one device (the same global batch and mean loss; its 8-device
  steps abort test workers under a full parallel test run's load, see
  ``tests/test_torch_pipeline.py``): every loss at rtol 2e-4, the
  gathered params as ``tests/test_torch_dist_train.py`` holds them;
- the MoE model (4 experts, top 2, capacity factor 1.0) at dp=2 x sp=2,
  whose layers route the global batch's tokens in the reference's
  order (rows of both batch ranks, each row's sequence blocks in turn),
  against the reference's step on one device, and under GPipe at pp=2 x
  sp=2, where each sequence block is routed on its own and the aux
  averaged over sp, against the reference's step on the same 4-device
  topology; the same tolerances;
- sp > 1 with the 1F1B schedule raises the reference's ``ValueError``.

The reference runs first, then the ranks.
"""
import concurrent.futures as cf
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_workers as workers
from test_torch_pipeline import jax_steps
from paddle_tpu.distributed import sequence_parallel as jsp
from paddle_tpu.distributed.mesh import HybridTopology as JTopology
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.models import llama as tllama

TIMEOUT = 300.0
# (kind, causal, grad, shape (B, S, H, Hkv, D)) by world size
ATTN = {2: [("ring", True, True, (2, 32, 4, 4, 8)),
            ("ring", False, False, (2, 16, 4, 4, 8)),
            ("ulysses", True, False, (2, 32, 8, 8, 8))],
        4: [("ring", True, True, (2, 16, 4, 4, 8)),
            ("ring", True, False, (2, 32, 8, 2, 8)),
            ("ring", False, False, (2, 16, 4, 4, 8)),
            ("ulysses", True, False, (2, 32, 8, 8, 8))]}
FIELDS = dict(vocab_size=128, hidden_size=64, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=64)
B, S, STEPS, LR = 4, 32, 3, 3e-4
STEP_CASES = {"dp2xmp2xsp2": (8, dict(dp=2, mp=2, sp=2), {}),
              "pp2xsp2_gpipe": (4, dict(pp=2, sp=2),
                                dict(n_microbatches=2, schedule="gpipe")),
              "moe_dp2xsp2": (4, dict(dp=2, sp=2), {}),
              "moe_pp2xsp2_gpipe": (4, dict(pp=2, sp=2),
                                    dict(n_microbatches=2,
                                         schedule="gpipe"))}
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qkv(shape, seed):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, hkv, hkv)]


def _jax_attention(n, cases, inputs):
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("sp",))
    out = []
    for (kind, causal, grad, _), (q, k, v) in zip(cases, inputs):
        fn = (jsp.ring_attention_sharded if kind == "ring"
              else jsp.ulysses_attention_sharded)

        def run(a, b, c):
            return fn(a, b, c, mesh, "sp", causal=causal)

        res = {"out": np.asarray(jax.jit(run)(q, k, v))}
        if grad:
            res["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
                lambda a, b, c: jnp.sum(run(a, b, c) ** 2),
                argnums=(0, 1, 2)))(q, k, v)]
        out.append(res)
    return out


def _batches():
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, FIELDS["vocab_size"], (B, S)).astype(
        np.int32) for k in ("input_ids", "labels")} for _ in range(STEPS)]


def _jcfg(**kw):
    return jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                              **FIELDS, **kw)


@pytest.fixture(scope="module")
def runs():
    inputs = {n: [_qkv(c[3], seed=10 * n + i) for i, c in enumerate(cases)]
              for n, cases in ATTN.items()}
    np_params = _np(jllama.init_params(_jcfg(), jax.random.PRNGKey(0)))
    moe_params = _np(jllama.init_params(_jcfg(**MOE),
                                        jax.random.PRNGKey(0)))
    batches = _batches()
    ref = {n: _jax_attention(n, cases, inputs[n])
           for n, cases in ATTN.items()}
    dense = jax_steps(_jcfg(), np_params, batches)
    ref_steps = {name: dense for name in STEP_CASES
                 if not name.startswith("moe")}
    ref_steps["moe_dp2xsp2"] = jax_steps(_jcfg(**MOE), moe_params, batches)
    n, topo_kw, step_kw = STEP_CASES["moe_pp2xsp2_gpipe"]
    ref_steps["moe_pp2xsp2_gpipe"] = jax_steps(
        _jcfg(**MOE), moe_params, batches, n, topo_kw, step_kw)
    worlds = {}
    for name, (n, topo_kw, step_kw) in STEP_CASES.items():
        own = (MOE, moe_params) if name.startswith("moe") else ()
        worlds.setdefault(n, []).append((name, (topo_kw, step_kw, *own)))
    with cf.ThreadPoolExecutor(4) as pool:
        futs = {n: pool.submit(spawn, workers.attention_cases, n,
                               (inputs[n], [c[:3] for c in cases]),
                               device="cpu", timeout=TIMEOUT)
                for n, cases in ATTN.items()}
        step_futs = {n: pool.submit(
            spawn, workers.train_cases, n,
            (FIELDS, np_params, batches, [c for _, c in world]),
            device="cpu", timeout=TIMEOUT)
            for n, world in worlds.items()}
        port = {n: f.result(timeout=TIMEOUT + 30) for n, f in futs.items()}
        steps = {}
        for n, world in worlds.items():
            ranks = step_futs[n].result(timeout=TIMEOUT + 30)
            for i, (name, _) in enumerate(world):
                steps[name] = [r[i] for r in ranks]
    return {"ref": ref, "port": port, "ref_steps": ref_steps,
            "steps": steps}


@pytest.mark.parametrize("n,i", [(n, i) for n, cases in ATTN.items()
                                 for i in range(len(cases))])
def test_attention_matches_jax(runs, n, i):
    ref = runs["ref"][n][i]
    for r in runs["port"][n]:
        np.testing.assert_allclose(r[i]["out"], ref["out"], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("n,i", [(n, i) for n, cases in ATTN.items()
                                 for i, c in enumerate(cases) if c[2]])
def test_ring_grads_match_jax(runs, n, i):
    """Each rank holds the gradients of its blocks: q's from its own
    block, k's and v's from every rank's, by the reverse shifts."""
    ref = runs["ref"][n][i]["grads"]
    got = [sum(r[i]["grads"][j] for r in runs["port"][n]) for j in range(3)]
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_context_parallel_step_matches_jax(runs, name):
    ref = runs["ref_steps"][name]
    for r in runs["steps"][name]:
        np.testing.assert_allclose([x for x, _ in r["losses"]],
                                   ref["losses"], rtol=2e-4)
        workers.close_params(tllama._paths(r["params"]), ref["params"],
                             STEPS, LR)


def test_sp_with_1f1b_raises_the_reference_error():
    cfg = tllama.LlamaConfig(**FIELDS)
    topo = types.SimpleNamespace(pp_degree=2, mp_degree=1, sp_degree=2)
    with pytest.raises(ValueError) as got:
        tllama.build_train_step(cfg, topo, schedule="1f1b", device="cpu")
    with pytest.raises(ValueError) as want:
        jllama.build_train_step(_jcfg(), JTopology(
            pp=2, sp=2, devices=jax.devices()[:4]), schedule="1f1b")
    assert str(got.value) == str(want.value)
