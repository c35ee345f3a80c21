"""The port's ERNIE pretraining (``paddle_tpu_torch/models/ernie.py``)
against the JAX reference on the CPU.

Weights are drawn by JAX and cross with ``params_from_jax``; batches
come from numpy seeds, in both of the reference's formats (dense
``mlm_labels`` and gathered ``masked_positions`` / ``masked_labels``),
with padded rows.  Tolerances, float32: sequence and pooled outputs
atol 1e-5; the losses atol 1e-5; each gradient leaf max |diff| <= 1e-4
x max |ref|, the scale floored at 1e-6 (``b_k``'s gradient is exactly
zero, softmax ignoring a shift of a row's scores: both sides hold
rounding noise of ~1e-12 there); three steps of ``build_pretrain_step`` at world size 1
against the reference's step on one device, losses atol 1e-5 (torch's
AdamW decays the parameter before adding the step, optax in one update:
one f32 rounding apart); the same steps over four gloo ranks at
dp2 x mp2, pp2 x sp2 and dp2 x sharding2 (one world, in turn) against
the reference's single-device step, atol 1e-4 (the mp sums run in
another order; pp, sp and sharding run the reference's placement: the
layer stack split over pp, sp and sharding replicated).
"""
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from paddle_tpu.distributed.mesh import HybridTopology as JTopology
from paddle_tpu.models import ernie as jernie
from paddle_tpu_torch.distributed import HybridTopology
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2)
B, S, P_SLOTS, STEPS = 4, 16, 8, 3
# the topologies the 4-rank world runs, in turn
CASES = (dict(dp=2, mp=2), dict(pp=2, sp=2), dict(dp=2, sharding=2))
TIMEOUT = 240.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, dense=True):
    """A pretraining batch: ~25 % of the positions masked ([MASK] = 3),
    row 1 padded after position 11, two segments."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, FIELDS["vocab_size"], (B, S))
    labels = np.full((B, S), -1, np.int64)
    masked = rng.random((B, S)) < 0.25
    masked[:, 0] = False
    masked[1, 12:] = False
    labels[masked] = ids[masked]
    ids = np.where(masked, 3, ids)
    am = np.ones((B, S), np.int64)
    am[1, 12:] = 0
    tt = np.zeros((B, S), np.int64)
    tt[:, S // 2:] = 1
    out = {"input_ids": ids, "token_type_ids": tt, "attention_mask": am,
           "nsp_labels": rng.integers(0, 2, (B,))}
    if dense:
        out["mlm_labels"] = labels
        return out
    pos = np.zeros((B, P_SLOTS), np.int64)
    plab = np.full((B, P_SLOTS), -1, np.int64)
    for b in range(B):
        where = np.nonzero(labels[b] >= 0)[0][:P_SLOTS]
        pos[b, :len(where)] = where
        plab[b, :len(where)] = labels[b][where]
    out.update(masked_positions=pos, masked_labels=plab)
    return out


def _jb(batch):
    return {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def model():
    cfg = jernie.ErnieConfig(**FIELDS)
    jp = jernie.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, _np(jp)


def _port(np_params, grad=False):
    tp = convert.params_from_jax(np_params, device="cpu")
    for t in tllama._paths(tp).values():
        t.requires_grad_(grad)
    return tp


def test_forward_pure_with_padding_matches_jax(model):
    jcfg, jp, np_params = model
    tcfg = ternie.ErnieConfig(**FIELDS)
    b = _batch(1)
    seq, pooled = jernie.forward_pure(jcfg, jp, *(jnp.asarray(b[k]) for k in
                                                  ("input_ids",
                                                   "token_type_ids",
                                                   "attention_mask")))
    tp = _port(np_params)
    tseq, tpooled = ternie.forward_pure(tcfg, tp, b["input_ids"],
                                        b["token_type_ids"],
                                        b["attention_mask"])
    np.testing.assert_allclose(tseq.numpy(), np.asarray(seq), atol=1e-5)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled),
                               atol=1e-5)
    # a padded position does not reach the others
    other = dict(b, input_ids=b["input_ids"].copy())
    other["input_ids"][1, 12:] = 5
    oseq, _ = ternie.forward_pure(tcfg, tp, other["input_ids"],
                                  other["token_type_ids"],
                                  other["attention_mask"])
    np.testing.assert_allclose(oseq[1, :12].numpy(), tseq[1, :12].numpy(),
                               atol=1e-6)


def test_pretrain_loss_both_formats_and_gradients_match_jax(model):
    jcfg, jp, np_params = model
    tcfg = ternie.ErnieConfig(**FIELDS)
    dense, gathered = _batch(2), _batch(2, dense=False)
    ref = {}
    for name, b in (("dense", dense), ("gathered", gathered)):
        (total, parts), g = jax.value_and_grad(
            lambda p: jernie.pretrain_loss(jcfg, p, _jb(b)), has_aux=True)(jp)
        ref[name] = (float(total), float(parts["mlm"]), float(parts["nsp"]),
                     tllama._paths(_np(g)))
    got = {}
    for name, b in (("dense", dense), ("gathered", gathered)):
        tp = _port(np_params, grad=True)
        total, parts = ternie.pretrain_loss(tcfg, tp, _tb(b))
        total.backward()
        got[name] = (total.item(), parts["mlm"].item(), parts["nsp"].item(),
                     {k: t.grad.numpy() for k, t in
                      tllama._paths(tp).items()})
    for name in got:
        np.testing.assert_allclose(got[name][:3], ref[name][:3], atol=1e-5)
        for k, r in ref[name][3].items():
            g = got[name][3][k]
            assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(),
                                                     1e-6), (name, k)
    # the two formats are the same loss
    np.testing.assert_allclose(got["dense"][:3], got["gathered"][:3],
                               atol=1e-6)


def test_no_masked_label_gives_a_zero_mlm_term(model):
    _, _, np_params = model
    tcfg = ternie.ErnieConfig(**FIELDS)
    b = _batch(3)
    b["mlm_labels"] = np.full_like(b["mlm_labels"], -1)
    _, parts = ternie.pretrain_loss(tcfg, _port(np_params), _tb(b))
    assert parts["mlm"].item() == 0.0


def _jax_steps(jcfg, batches):
    topo = JTopology(dp=1, pp=1, sharding=1, mp=1,
                     devices=jax.devices()[:1])
    step, init = jernie.build_pretrain_step(jcfg, topo)
    params, opt = init(jax.random.PRNGKey(0))
    start = _np(params)
    out = []
    for b in batches:
        params, opt, m = step(params, opt, _jb(b))
        out.append({k: float(v) for k, v in m.items()})
    return start, out


@pytest.fixture(scope="module")
def steps():
    """The reference's single-device step over three batches (gathered,
    dense, gathered), the port at world size 1 in this process and, as
    four gloo ranks, at each topology of ``CASES``, all from the
    reference's init."""
    jcfg = jernie.ErnieConfig(**FIELDS)
    batches = [_batch(10), _batch(11, dense=True), _batch(12)]
    batches[0] = _batch(10, dense=False)
    batches[2] = _batch(12, dense=False)
    start, ref = _jax_steps(jcfg, batches)
    with cf.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, workers.ernie_steps, 4,
                          (FIELDS, start, batches, CASES),
                          device="cpu", timeout=TIMEOUT)
        tcfg = ternie.ErnieConfig(**FIELDS)
        step, init = ternie.build_pretrain_step(tcfg, HybridTopology(),
                                                device="cpu")
        params, opt = init(params=ternie.shard_params(
            tcfg, start, HybridTopology(), device="cpu"))
        ws1 = []
        for b in batches:
            params, opt, m = step(params, opt, _tb(b))
            ws1.append({k: v.item() for k, v in m.items()})
        ranks = fut.result(timeout=TIMEOUT + 30)
    return {"ref": ref, "ws1": ws1, "ranks": ranks, "start": start}


def test_pretrain_step_world_size_1_matches_jax(steps):
    for got, ref in zip(steps["ws1"], steps["ref"]):
        for k in ("loss", "mlm", "nsp"):
            assert abs(got[k] - ref[k]) <= 1e-5, (k, got, ref)
    assert steps["ws1"][-1]["loss"] != steps["ws1"][0]["loss"]


def _case(steps, i):
    return [r[i] for r in steps["ranks"]]


def _losses_match(ranks, ref):
    for r in ranks:
        assert len(r["metrics"]) == STEPS
        for got, want in zip(r["metrics"], ref):
            for k in ("loss", "mlm", "nsp"):
                assert abs(got[k] - want[k]) <= 1e-4, (k, got, want)


def test_pretrain_step_dp2_mp2_matches_jax_single_device(steps):
    ranks = _case(steps, 0)
    coords = sorted((r["coords"]["dp"], r["coords"]["mp"]) for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _losses_match(ranks, steps["ref"])


def test_pretrain_step_pp2_sp2_matches_jax_single_device(steps):
    ranks = _case(steps, 1)
    coords = sorted((r["coords"]["pp"], r["coords"]["sp"]) for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _losses_match(ranks, steps["ref"])


def test_pretrain_step_dp2_sharding2_matches_jax_single_device(steps):
    ranks = _case(steps, 2)
    coords = sorted((r["coords"]["dp"], r["coords"]["sharding"])
                    for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _losses_match(ranks, steps["ref"])


def test_pp_slices_hold_the_reckoned_bytes(steps):
    """At pp=2 a rank holds half of every stacked layer leaf and the
    rest whole (float32), and AdamW's two moments of exactly those; at
    dp x sharding every rank holds everything (no spec names
    sharding)."""
    flat = tllama._paths(steps["start"])
    layers = sum(v.size * 4 for k, v in flat.items()
                 if k.startswith("layers"))
    rest = sum(v.size * 4 for k, v in flat.items()
               if not k.startswith("layers"))
    for r in _case(steps, 1):
        assert r["weight_bytes"] == rest + layers // 2
        assert r["state_bytes"] == 2 * r["weight_bytes"]
    for r in _case(steps, 2):
        assert r["weight_bytes"] == rest + layers
        assert r["state_bytes"] == 2 * r["weight_bytes"]


def test_param_specs_and_unsupported_axes(steps):
    """The specs are the reference's, and pp, sp and sharding, which the
    port refused before it ran the reference's placement, now train
    (every rank of those topologies ran every step)."""
    for i in (1, 2):
        assert all(len(r["metrics"]) == STEPS for r in _case(steps, i))
    cfg = ternie.ErnieConfig(**FIELDS)
    jspecs = jernie.param_specs(jernie.ErnieConfig(**FIELDS))
    tspecs = ternie.param_specs(cfg)
    flat_j = tllama._paths(jax.tree_util.tree_map(
        tuple, jspecs, is_leaf=lambda x: not isinstance(x, dict)))
    assert tllama._paths(tspecs) == flat_j
