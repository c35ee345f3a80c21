"""``Plan.run_train_loop``'s in-process elastic resize against the JAX
reference (``tests/test_plan.py``'s resize cases).

Four gloo ranks on the CPU (``tests/torch_dist_workers.py``, no JAX) run
``Plan(dp=4)`` over 6 global batches of 8 rows from JAX's ``llama-debug``
params; a resize to 2 is requested before step 3: the state is saved
through ``ckpt_root``, the plan refitted, the step rebuilt over ranks 0
and 1 and the state restored resharded; ranks 2 and 3 leave.  The resize
keeps the global batch, so the math is data parallelism's: the losses
are held to JAX's ``Plan().run_train_loop`` on one device over the same
batches at float32 atol 2e-5 (the summation order of the gradient sums
differs).  A request written by rank 1 just after rank 0 read the key
for step 3 resizes every rank at step 4 (rank 0 reads, the ranks agree
by a broadcast).  A second resize follows a first (4 -> 2 -> 1): the
groups of a topology over part of the world are made by its members
alone, so the ranks that left take no part.  Without a ``ckpt_root`` the
resize raises ``PlanError``, as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from paddle_tpu.distributed.plan import Plan as JPlan
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.distributed.plan import Plan
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(jllama.PRESETS["llama-debug"])
TIMEOUT = 300.0
STEPS, B, S = 6, 8, 32


def _setup():
    cfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                             **FIELDS)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    V = FIELDS["vocab_size"]
    batches = [{"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
                "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
               for _ in range(STEPS)]
    return cfg, params, batches


@pytest.fixture(scope="module")
def jax_ref():
    cfg, params, batches = _setup()
    ref = JPlan().run_train_loop(cfg, batches, devices=jax.devices()[:1],
                                 rng=jax.random.PRNGKey(0), verify=False)
    return params, batches, ref["losses"]


@pytest.mark.parametrize("between", [False, True],
                         ids=["requested_before_step3",
                              "written_between_polls"])
def test_resize_4_to_2_matches_jax(tmp_path, jax_ref, between):
    params, batches, ref = jax_ref
    at = 4 if between else 3
    ranks = spawn(workers.resize_loop, 4,
                  (FIELDS, params, batches, 4, 3, 2, str(tmp_path / "ck"),
                   between), device="cpu", timeout=TIMEOUT)
    for r in ranks:
        assert r["resizes"] == [(at, 4, 2)], (r["rank"], r["resizes"])
    for r in ranks[:2]:
        assert r["world_sizes"] == [4] * at + [2] * (STEPS - at)
        np.testing.assert_allclose(r["losses"], ref, atol=2e-5, rtol=0)
        (st,) = r["resize_stats"]
        assert st["step"] == at and st["saved_bytes"] > 0
        assert min(st["save_s"], st["group_s"], st["restore_s"]) >= 0
    for r in ranks[2:]:
        # the leavers return the steps they ran
        assert r["world_sizes"] == [4] * at
        np.testing.assert_allclose(r["losses"], ref[:at], atol=2e-5,
                                   rtol=0)
    # the ranks of one plan agree bit for bit
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_resize_4_to_2_to_1_matches_jax(tmp_path, jax_ref):
    params, batches, ref = jax_ref
    ranks = spawn(workers.resize_loop, 4,
                  (FIELDS, params, batches, 4, 2, 2, str(tmp_path / "ck"),
                   False, ((4, 1),)), device="cpu", timeout=TIMEOUT)
    both = [(2, 4, 2), (4, 2, 1)]
    assert [r["resizes"] for r in ranks] == [both, both, both[:1],
                                             both[:1]]
    assert [r["world_sizes"] for r in ranks] == [
        [4, 4, 2, 2, 1, 1], [4, 4, 2, 2], [4, 4], [4, 4]]
    for r in ranks:
        # float32 atol 2e-5: the summation order of the gradient sums
        np.testing.assert_allclose(r["losses"], ref[:len(r["losses"])],
                                   atol=2e-5, rtol=0)
    assert [st["step"] for st in ranks[0]["resize_stats"]] == [2, 4]
    assert [st["step"] for st in ranks[1]["resize_stats"]] == [2]
    assert ranks[1]["losses"] == ranks[0]["losses"][:4]


def test_resize_needs_ckpt_root(jax_ref):
    params, batches, _ = jax_ref
    with pytest.raises(RuntimeError, match="PlanError: resize requested "
                                           "but run_train_loop was given "
                                           "no ckpt_root"):
        spawn(workers.resize_loop, 2,
              (FIELDS, params, batches[:2], 2, 1, 1, None), device="cpu",
              timeout=TIMEOUT)


@pytest.mark.parametrize("want", [b"2", b"1"], ids=["above_world",
                                                     "same_size"])
def test_request_that_is_no_resize_is_ignored(want):
    """A world of one asked for 2 ranks (more than the world has, as the
    reference ignores ``want > len(devices)``) or for 1 (its own size)
    runs on without a checkpoint."""
    class Store:
        def get(self, k):
            return want

    cfg = tllama.LlamaConfig(dtype=torch.float32, **FIELDS)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, FIELDS["vocab_size"],
                                              (4, 8)))
             for k in ("input_ids", "labels")}
    hist = Plan().run_train_loop(cfg, [batch, batch], device="cpu",
                                 scale_store=Store())
    assert hist["world_sizes"] == [1, 1] and hist["resizes"] == []
