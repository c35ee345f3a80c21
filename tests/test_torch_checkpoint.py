"""The port's step-directory checkpoints (``distributed/checkpoint.py``,
the counterpart of the reference's orbax backend) and the train step
saved, restored and resumed.

The slice as a whole: ``llama-debug`` in float32 from the JAX package's
weights through ``Plan().train_step``: 2 steps, a save, a restore into a
fresh ``init_fn``, 2 more steps.  The
losses must be bit-identical to the port's own uninterrupted 4 steps,
and within atol 2e-5 of JAX's ``Plan().run_train_loop`` over the same 4
batches (float32; the reference's tolerance for the distributed step).
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.plan import Plan as JPlan
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import checkpoint as dckpt
from paddle_tpu_torch.distributed import fault_tolerance as ft
from paddle_tpu_torch.distributed import reshard
from paddle_tpu_torch.distributed.plan import Plan
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.testing import chaos

FIELDS = dict(jllama.PRESETS["llama-debug"])


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.uninstall()
    dckpt.wait_until_finished()
    ft.reset_stats()


def _batches(n, B=4, S=16, seed=3):
    rng = np.random.default_rng(seed)
    V = FIELDS["vocab_size"]
    return [{"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
            for _ in range(n)]


def test_save_load_round_trip_is_bit_exact(tmp_path):
    tree = {"w": torch.randn(8, 4).to(torch.bfloat16),
            "m": {"a": torch.randn(3), "step": torch.tensor(4.0)},
            "meta": [1, "x"]}
    dckpt.save(str(tmp_path / "ck"), tree)
    got = dckpt.load(str(tmp_path / "ck"))
    assert torch.equal(got["w"], tree["w"]) and got["w"].dtype == \
        torch.bfloat16
    assert torch.equal(got["m"]["a"], tree["m"]["a"])
    assert got["meta"] == [1, "x"]
    assert sorted(os.listdir(tmp_path / "ck")) == [ft.MANIFEST_NAME,
                                                    dckpt.STATE_FILE]
    # a target places the leaves and holds their shapes
    got = dckpt.load(str(tmp_path / "ck"), target={"w": tree["w"]})
    assert torch.equal(got["w"], tree["w"])
    with pytest.raises(ValueError, match="does not match"):
        dckpt.load(str(tmp_path / "ck"), target={"w": torch.zeros(2)})


def test_async_save_holds_a_snapshot_the_next_step_cannot_alter(tmp_path):
    w = torch.arange(6.0)
    gate = threading.Event()
    # hold the writer until the caller has updated w in place, as the
    # next optimizer step would
    orig = dckpt._write

    def slow_write(tmp, tree):
        gate.wait(10)
        orig(tmp, tree)

    dckpt._write = slow_write
    try:
        dckpt.save_step(str(tmp_path), {"w": w}, 1, sync=False)
        w.add_(100.0)
        gate.set()
        dckpt.wait_until_finished()
    finally:
        dckpt._write = orig
    state, step = dckpt.load_step(str(tmp_path))
    assert step == 1 and torch.equal(state["w"], torch.arange(6.0))


def test_pruning_skips_a_step_still_in_flight(tmp_path):
    root = str(tmp_path)
    gate = threading.Event()
    orig = dckpt._write

    def slow_write(tmp, tree):
        if tree["s"] == 2:
            gate.wait(10)
        orig(tmp, tree)

    dckpt._write = slow_write
    try:
        dckpt.save_step(root, {"s": 1}, 1, keep=1)
        dckpt.save_step(root, {"s": 2}, 2, keep=1, sync=False)
        dckpt.save_step(root, {"s": 3}, 3, keep=1)   # prunes around 2
        assert os.path.isdir(os.path.join(root, ft.step_dir_name(2)
                                          + ft.TMP_SUFFIX))
        gate.set()
        dckpt.wait_until_finished()
    finally:
        dckpt._write = orig
    assert dckpt.latest_step(root) == 3
    assert ft.committed_steps(root) == [3]


def test_load_step_falls_back_past_a_corrupt_step(tmp_path):
    root = str(tmp_path)
    for s in (1, 2):
        dckpt.save_step(root, {"w": torch.full((100,), float(s))}, s)
    chaos.truncate_file(os.path.join(root, ft.step_dir_name(2),
                                     dckpt.STATE_FILE))
    state, step = dckpt.load_step(root)
    assert step == 1 and float(state["w"][0]) == 1.0
    assert ft.stats()["fallbacks"] == 1
    with pytest.raises(ft.CheckpointCorruptionError):
        dckpt.load_step(root, step=2)
    with pytest.raises(FileNotFoundError):
        dckpt.load_step(str(tmp_path / "empty"))


def test_a_failed_async_commit_surfaces_in_wait(tmp_path):
    with chaos.installed("raise@ckpt.commit.pre:step=5"):
        dckpt.save_step(str(tmp_path), {"w": torch.ones(2)}, 5, sync=False)
        with pytest.raises(chaos.ChaosError):
            dckpt.wait_until_finished()
    assert dckpt.latest_step(str(tmp_path)) is None


def test_manager_async_save_then_restore(tmp_path):
    mgr = ft.CheckpointManager(str(tmp_path), save_interval_steps=2, keep=2)
    assert mgr.backend == "orbax" and not mgr.sync
    for s in range(1, 7):
        saved = mgr.step_end(s, {"w": torch.full((3,), float(s))})
        assert saved == (s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [4, 6]
    state, step = mgr.restore()
    assert step == 6 and torch.equal(state["w"], torch.full((3,), 6.0))
    assert ft.pinned_steps(str(tmp_path)) == {6}
    assert mgr.restore(step=4)[1] == 4
    assert ft.CheckpointManager(str(tmp_path / "new")).restore() == (None, 0)


def _cfg(**kw):
    return tllama.LlamaConfig(dtype=torch.float32, fused_blocks="off",
                              **FIELDS, **kw)


def _jax_params():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                              **FIELDS)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def test_save_train_state_into_a_zero_optimizer(tmp_path):
    cfg = _cfg()
    step, init = Plan().train_step(cfg, device="cpu")
    params, opt = init(0)
    step(params, opt, step.shard_batch(_batches(1)[0]))
    dckpt.save_train_state(str(tmp_path), params, opt, 1)
    p2, o2 = init(5)
    got_p, got_o, s = dckpt.load_train_state(str(tmp_path), p2, o2)
    assert s == 1 and got_o is o2
    want = opt.state_tree()
    for path, st in o2.state_tree().items():
        for k, v in st.items():
            assert torch.equal(v, want[path][k]), (path, k)
    for (path, a), (_, b) in zip(reshard._flat(got_p),
                                 reshard._flat(params)):
        assert torch.equal(a, b), path


def test_train_step_resumes_bit_identically_and_matches_jax(tmp_path):
    jcfg, np_params = _jax_params()
    batches = _batches(4)
    ref = JPlan().run_train_loop(jcfg, batches, devices=jax.devices()[:1],
                                 rng=jax.random.PRNGKey(0), verify=False)
    cfg = _cfg()
    step, init = Plan().train_step(cfg, device="cpu")

    def start():
        return init(params=tllama.shard_params(cfg, np_params,
                                               step.plan_topology,
                                               device="cpu"))

    def run(params, opt, bs):
        return [step(params, opt, step.shard_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}))[2][
                "loss"].item() for b in bs]

    params, opt = start()
    whole = run(params, opt, batches)
    params, opt = start()
    first = run(params, opt, batches[:2])
    mgr = ft.CheckpointManager(str(tmp_path), specs=tllama.param_specs(cfg))
    mgr.save(2, reshard.gather_train_state(params, opt), sync=True)
    del params, opt
    state, got = mgr.restore()
    assert got == 2
    params, opt = init(params=state["params"])
    opt.load_state_tree(state["opt_state"])
    resumed = first + run(params, opt, batches[2:])
    assert resumed == whole           # bit for bit
    np.testing.assert_allclose(resumed, ref["losses"], atol=2e-5, rtol=0)
    man = ft.read_manifest(os.path.join(str(tmp_path), ft.step_dir_name(2)))
    assert man["shardings"]["params/layers/wq"]["spec"] == [["pp"], None,
                                                            ["mp"]]
    assert man["shardings"]["opt_state/layers/wq/exp_avg"]["spec"] == \
        [["pp"], None, ["mp"]]
    assert man["topology"]["world_size"] == 1
    assert len(man["rng"]["cpu"]) == torch.get_rng_state().numel()
