"""The port's tensor-parallel layers, ``split``, the RNG tracker and
``recompute`` (``paddle_tpu_torch.distributed``) against the JAX
reference on the CPU.

One 2-rank gloo world at mp=2 (``torch_dist_workers.mp_world``) holds
the layers' blocks of full float32 weights drawn here by numpy; the
blocks the ranks return are put back together and held against the
reference's full-weight layers (``paddle_tpu.distributed.fleet``
outside a mesh: plain math), atol 1e-5 on the outputs, the per-token
losses and every gradient.  Layers drawn from one seed at mp=2 hold
exactly the blocks of the layers a world of one draws (bit-equal).

``recompute`` runs in this process: against the reference's
``recompute`` with dropout 0 (rtol 1e-5), and with dropout > 0 against
the port's own run without it, bit-equal; ``torch.utils.checkpoint``'s
own ``preserve_rng_state`` does not give those gradients (the port's
draws come from its own generators), which is what the port's recompute
stashes and restores.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import torch_dist_workers as workers
import paddle_tpu_torch as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import recompute as jrecompute
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet

V, H, I, B, S = 16, 8, 12, 2, 5
SEED = 11
TIMEOUT = 120.0


def _full():
    rng = np.random.default_rng(3)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return {"emb": w(V, H), "w1": w(H, I), "b1": w(I), "w2": w(I, H),
            "b2": w(H), "w3": w(H, V), "b3": w(V)}


def _data():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (B, S))
    labels = rng.integers(0, V, (B, S))
    labels[0, 1] = labels[1, 3] = -100
    x = rng.standard_normal((B, H)).astype(np.float32)
    return ids, labels, x


@pytest.fixture(scope="module")
def world():
    full = _full()
    ids, labels, x = _data()
    ranks = dist.spawn(workers.mp_world, args=(full, ids, labels, x, SEED),
                       nprocs=2, device="cpu", timeout=TIMEOUT)
    return sorted(ranks, key=lambda r: r["rank"])


def _reference():
    """The reference's layers on the full weights (no mesh): outputs,
    per-token losses and gradients."""
    full = _full()
    ids, labels, x = _data()
    emb = jfleet.VocabParallelEmbedding(V, H)
    col = jfleet.ColumnParallelLinear(H, I, gather_output=False)
    row = jfleet.RowParallelLinear(I, H, input_is_parallel=True)
    head = jfleet.ColumnParallelLinear(H, V, gather_output=False)
    for layer, names in ((emb, {"weight": "emb"}),
                         (col, {"weight": "w1", "bias": "b1"}),
                         (row, {"weight": "w2", "bias": "b2"}),
                         (head, {"weight": "w3", "bias": "b3"})):
        layer.set_state_dict({k: full[v] for k, v in names.items()})
    logits = head(row(col(emb(jpaddle.to_tensor(ids)))))
    per = jfleet.ParallelCrossEntropy(ignore_index=-100)(
        logits, jpaddle.to_tensor(labels))
    loss = jpaddle.mean(per)
    loss.backward()
    grads = {f"{n}.{k}": getattr(l, k).grad.numpy()
             for n, l in (("emb", emb), ("col", col), ("row", row),
                          ("head", head)) for k in ("weight", "bias")
             if getattr(l, k, None) is not None}
    colg = jfleet.ColumnParallelLinear(H, I, gather_output=True)
    colg.set_state_dict({"weight": full["w1"], "bias": full["b1"]})
    rowf = jfleet.RowParallelLinear(I, H)
    rowf.set_state_dict({"weight": full["w2"], "bias": full["b2"]})
    xt = jpaddle.to_tensor(x)
    xt.stop_gradient = False
    y = rowf(colg(xt))
    jpaddle.sum(y * y).backward()
    return dict(loss=loss.item(), per=per.numpy(), logits=logits.numpy(),
                grads=grads, whole=y.numpy(), whole_x_grad=xt.grad.numpy())


# which dim of each gradient is split over mp (None: whole on each rank)
SPLIT = {"emb.weight": 0, "col.weight": 1, "col.bias": 0, "row.weight": 0,
         "row.bias": None, "head.weight": 1, "head.bias": 0}


def test_mp_layers_match_the_references_full_weight_layers(world):
    ref = _reference()
    for r in world:
        assert abs(r["loss"] - ref["loss"]) <= 1e-5
        np.testing.assert_allclose(r["per"], ref["per"], atol=1e-5)
        assert (r["per"][0, 1], r["per"][1, 3]) == (0.0, 0.0)
        np.testing.assert_allclose(r["whole"], ref["whole"], atol=1e-5)
        np.testing.assert_allclose(r["whole_x_grad"], ref["whole_x_grad"],
                                   atol=1e-5)
    # the vocab-split logits, put together
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in world], -1), ref["logits"],
        atol=1e-5)
    for name, dim in SPLIT.items():
        got = (world[0]["grads"][name] if dim is None else
               np.concatenate([r["grads"][name] for r in world], dim))
        np.testing.assert_allclose(got, ref["grads"][name], atol=1e-5,
                                   err_msg=name)
        if dim is None:
            np.testing.assert_array_equal(world[1]["grads"][name], got)


def test_each_rank_holds_half_the_weights(world):
    full = _full()
    total = sum(v.nbytes for v in full.values())
    for r in world:
        # every leaf split but the row-parallel bias
        assert r["weight_bytes"] == (total - full["b2"].nbytes) // 2 \
            + full["b2"].nbytes


def test_layers_drawn_from_a_seed_hold_the_world_of_ones_blocks(world):
    """A layer at mp=2 draws the full weight and keeps its block, so it
    holds the blocks of the layer drawn at world size 1 from the same
    seed; ``split`` (a column-parallel linear, gathered) gives that
    layer's output."""
    paddle.set_device("cpu")
    x = _data()[2]
    paddle.seed(SEED)
    ws1 = {"col": fleet.ColumnParallelLinear(H, I).weight.numpy(),
           "row": fleet.RowParallelLinear(I, H).weight.numpy(),
           "emb": fleet.VocabParallelEmbedding(V, H).weight.numpy()}
    paddle.seed(SEED)
    split = dist.split(paddle.to_tensor(x), (H, I), "linear", axis=1)
    for name, dim in (("col", 1), ("row", 0), ("emb", 0)):
        np.testing.assert_array_equal(
            np.concatenate([r["drawn"][name] for r in world], dim),
            ws1[name])
    for r in world:
        np.testing.assert_allclose(r["drawn"]["split"], split.numpy(),
                                   atol=1e-6)


def test_rng_tracker_masks_differ_by_mp_rank_only_inside(world):
    (in0, out0), (in1, out1) = (r["masks"] for r in world)
    assert not np.array_equal(in0, in1)
    np.testing.assert_array_equal(out0, out1)
    # the reference's check: two draws inside the tracker differ
    paddle.set_device("cpu")
    dist.model_parallel_random_seed(1234)
    tracker = dist.get_rng_state_tracker()
    with tracker.rng_state():
        a = paddle.randn([4])
    with tracker.rng_state():
        b = paddle.randn([4])
    assert not np.allclose(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="does not exist"):
        with tracker.rng_state("nope"):
            pass


# ---------------------------------------------------------------------------
# recompute
# ---------------------------------------------------------------------------

def _weights():
    rng = np.random.default_rng(9)
    return {"0.weight": (rng.standard_normal((6, 10)) * .3).astype(
        np.float32), "0.bias": np.zeros(10, np.float32),
        "3.weight": (rng.standard_normal((10, 6)) * .3).astype(np.float32),
        "3.bias": (rng.standard_normal(6) * .1).astype(np.float32)}


def _block(nn, p):
    net = nn.Sequential(nn.Linear(6, 10), nn.GELU(), nn.Dropout(p),
                        nn.Linear(10, 6))
    net.set_state_dict(_weights())
    return net


def _x():
    return np.random.default_rng(5).standard_normal((4, 6)).astype(
        np.float32)


def _port_run(how, p=0.3, seed=7):
    """Grads (params and input) of sum(tanh(block(x))^2) with the block
    run plainly or under a recompute; the draws from ``seed``."""
    paddle.set_device("cpu")
    net = _block(paddle.nn, p)
    x = paddle.to_tensor(_x())
    x.stop_gradient = False
    paddle.seed(seed)
    if how == "plain":
        h = net(x)
    elif how == "layer":
        h = dist.recompute(net, x)
    elif how == "closure":
        def create_custom_forward(block):
            def custom_forward(*inputs):
                return block(*inputs)
            return custom_forward
        h = dist.fleet.utils.recompute(create_custom_forward(net), x)
    elif how == "sequential":
        h = dist.recompute_sequential({"segments": 2}, list(net.children()),
                                      x)
    elif how == "no_preserve":
        h = dist.recompute(net, x, preserve_rng_state=False)
    elif how == "tracked":
        dist.model_parallel_random_seed(seed)
        with dist.get_rng_state_tracker().rng_state():
            h = dist.recompute(net, x)
    elif how == "tracked_plain":
        dist.model_parallel_random_seed(seed)
        with dist.get_rng_state_tracker().rng_state():
            h = net(x)
    elif how == "torch_checkpoint":
        h = paddle.Tensor._wrap(torch.utils.checkpoint.checkpoint(
            lambda t: net(paddle.Tensor._wrap(t))._t, x._t,
            use_reentrant=False, preserve_rng_state=True))
    loss = paddle.sum(paddle.tanh(h) ** 2)
    loss.backward()
    return [q.grad.numpy() for q in net.parameters()] + [x.grad.numpy()]


def test_recompute_matches_the_references_without_dropout():
    jnet = _block(jpaddle.nn, 0.0)
    x = jpaddle.to_tensor(_x())
    x.stop_gradient = False
    loss = jpaddle.sum(jpaddle.tanh(jrecompute(jnet, x)) ** 2)
    loss.backward()
    want = [q.grad.numpy() for q in jnet.parameters()] + [x.grad.numpy()]
    for how in ("layer", "closure", "sequential"):
        for g, w in zip(_port_run(how, p=0.0), want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=how)


@pytest.mark.parametrize("how", ["layer", "closure", "sequential"])
def test_recompute_with_dropout_is_bit_equal_to_the_plain_run(how):
    plain = _port_run("plain")
    for g, w in zip(_port_run(how), plain):
        np.testing.assert_array_equal(g, w)


def test_recompute_replays_the_trackers_draws():
    """Forward inside the tracker, backward outside it: the replay
    draws from the tracker's stashed state."""
    plain = _port_run("tracked_plain")
    for g, w in zip(_port_run("tracked"), plain):
        np.testing.assert_array_equal(g, w)


def test_torch_checkpoint_alone_misses_the_ports_generator():
    """The trap: torch's ``preserve_rng_state`` stashes torch's default
    generators, not the port's, so its replay draws another dropout mask
    (as does the port's recompute told not to preserve)."""
    plain = _port_run("plain")
    for how in ("torch_checkpoint", "no_preserve"):
        got = _port_run(how)
        assert not all(np.array_equal(g, w) for g, w in zip(got, plain)), how
