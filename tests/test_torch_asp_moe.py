"""incubate/asp and the eager MoE layer in the port against the reference
(``paddle_tpu_torch/incubate/asp/``,
``paddle_tpu_torch/incubate/distributed/models/moe/``; reference
``paddle_tpu/incubate/...``, its tests: the asp cases of
``tests/test_text_audio_asp.py`` and ``tests/test_moe.py``).

asp's masks equal the reference's bit for bit, the device (torch) 1-D
mask included, over bf16 weights with ties.  MoELayer's outputs, aux and
gradients agree with the reference's on the same weights (numpy) to
rtol 1e-4 / atol 1e-5 (float32).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate import asp as jasp
from paddle_tpu_torch.incubate import asp as tasp


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tasp.reset_excluded_layers()
    jasp.reset_excluded_layers()


# -- asp ---------------------------------------------------------------------

def test_mask_1d_properties():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    mask = tasp.get_mask_1d(w, 2, 4)
    np.testing.assert_array_equal(mask, jasp.get_mask_1d(w, 2, 4))
    assert tasp.check_mask_1d(mask, 2, 4)
    assert abs(tasp.calculate_density(mask) - 0.5) < 1e-6
    grouped = np.abs(w).reshape(-1, 4)
    kept = (mask.reshape(-1, 4) > 0)
    for g, k in zip(grouped, kept):
        assert set(np.argsort(g)[-2:]) == set(np.where(k)[0])


@pytest.mark.parametrize("shape", [(16, 32), (8, 6), (4, 3, 5), (6, 2, 3, 3)])
def test_device_mask_1d_equals_the_reference_bit_for_bit(shape):
    """The port's 1-D mask on a torch tensor (stable sort) against the
    reference's numpy mask, on bf16 values with many ties, padded last
    dims and tensors that are not 2-D."""
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.integers(-3, 4, shape).astype(np.float32)
                        * 0.5).to(torch.bfloat16)
    got = tasp.create_mask(w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    want = jasp.create_mask(w.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert tasp.check_sparsity(w * got) and tasp.check_sparsity(
        (w * got).float().numpy())


def test_mask_2d_greedy_and_best():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    for name in ("get_mask_2d_greedy", "get_mask_2d_best"):
        mask = getattr(tasp, name)(w, 2, 4)
        np.testing.assert_array_equal(mask, getattr(jasp, name)(w, 2, 4))
        assert tasp.check_mask_2d(mask, 2, 4)
        assert abs(tasp.calculate_density(mask) - 0.5) < 1e-6
    t = torch.as_tensor(w)
    for algo in ("mask_2d_greedy", "mask_2d_best"):
        np.testing.assert_array_equal(
            tasp.create_mask(t, func_name=algo).numpy(),
            jasp.create_mask(w, func_name=algo))
    assert tasp.check_sparsity(t * tasp.create_mask(t, "mask_2d_best"),
                               func_name="check_2d")


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(16, 32), pkg.nn.ReLU(),
                             pkg.nn.Linear(32, 8))


def test_prune_model_and_training_keeps_sparsity():
    jmodel = _mlp(jp)
    model = _mlp(tp)
    model.set_state_dict({k: v.numpy() for k, v in
                          jmodel.state_dict().items()})
    jmasks = jasp.prune_model(jmodel, n=2, m=4)
    masks = tasp.prune_model(model, n=2, m=4)
    assert sorted(masks) == sorted(jmasks) and len(masks) == 2
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(),
                                      np.asarray(jmasks[k]))
    for _, p in model.named_parameters():
        if p.ndim == 2:
            assert tasp.check_sparsity(p)
    jopt = jasp.decorate(jp.optimizer.SGD(
        learning_rate=0.1, parameters=jmodel.parameters()))
    opt = tasp.decorate(tp.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = rng.standard_normal((8, 16)).astype(np.float32)
        for pkg, net, o in ((jp, jmodel, jopt), (tp, model, opt)):
            loss = pkg.mean(net(pkg.to_tensor(x)) ** 2)
            loss.backward()
            o.step()
            o.clear_grad()
    for (k, p), (_, jpar) in zip(model.named_parameters(),
                                 jmodel.named_parameters()):
        if p.ndim == 2:
            assert tasp.check_sparsity(p), "sparsity lost after training"
        np.testing.assert_allclose(p.numpy(), jpar.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_excluded_layers():
    model = tp.nn.Sequential(tp.nn.Linear(8, 8), tp.nn.Linear(8, 8))
    tasp.set_excluded_layers(["0."])
    try:
        masks = tasp.prune_model(model)
        assert len(masks) == 1
    finally:
        tasp.reset_excluded_layers()


# -- MoE ---------------------------------------------------------------------

def _experts(pkg, n, d, h):
    return [pkg.nn.Sequential(pkg.nn.Linear(d, h), pkg.nn.GELU(),
                              pkg.nn.Linear(h, d)) for _ in range(n)]


def _pair(gate, n, d, h, top_k, cf, seed=0):
    from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoE
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    jp.seed(seed)
    jl = JMoE(d, _experts(jp, n, d, h), gate=gate, top_k=top_k,
              capacity_factor=cf)
    tl = MoELayer(d, _experts(tp, n, d, h), gate=gate, top_k=top_k,
                  capacity_factor=cf)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("gate_name", ["naive", "gshard", "switch"])
def test_moe_forward_shapes(gate_name):
    d = 16
    jl, tl = _pair(gate_name, 4, d, 32, 2, 2.0)
    x = np.random.default_rng(1).standard_normal((2, 6, d)).astype("float32")
    out = tl(tp.to_tensor(x))
    ref = jl(jp.to_tensor(x))
    assert out.shape == [2, 6, d]
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(tl.aux_loss), float(jl.aux_loss),
                               rtol=1e-5, atol=1e-7)
    if gate_name != "naive":
        assert float(tl.aux_loss) >= 0


def test_moe_matches_manual_top1():
    d = 8
    tp.seed(7)
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    experts = _experts(tp, 3, d, 16)
    layer = MoELayer(d, experts, gate="switch", top_k=1,
                     capacity_factor=8.0)
    x = tp.randn([1, 5, d])
    out = layer(x).numpy()[0]
    logits = layer.gate.linear(tp.reshape(x, [-1, d])).numpy()
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = probs.argmax(-1)
    xt = x.numpy()[0]
    for t in range(5):
        e = int(idx[t])
        ref = experts[e](tp.to_tensor(xt[t:t + 1])).numpy()[0]
        np.testing.assert_allclose(out[t], probs[t, e] * ref,
                                   rtol=1e-4, atol=1e-5)


def test_moe_backward_trains_experts_and_gate():
    d = 8
    jl, tl = _pair("gshard", 2, d, 16, 2, 4.0)
    x = np.random.default_rng(3).standard_normal((4, 3, d)).astype("float32")
    grads = {}
    for name, pkg, layer in (("j", jp, jl), ("t", tp, tl)):
        loss = pkg.mean(layer(pkg.to_tensor(x)) ** 2) + layer.aux_loss
        loss.backward()
        grads[name] = [None if p.grad is None else p.grad.numpy()
                       for p in layer.parameters()]
    for a, b in zip(grads["j"], grads["t"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    opt = tp.optimizer.Adam(learning_rate=1e-2, parameters=tl.parameters())
    before = [p.numpy().copy() for p in tl.parameters()]
    opt.step()
    after = [p.numpy() for p in tl.parameters()]
    changed = sum(not np.allclose(a, b) for a, b in zip(before, after))
    assert changed >= len(before) - 1  # the idx path has no gradient


def test_capacity_drops_tokens():
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    d = 4
    jl, tl = _pair("naive", 2, d, 8, 1, 0.01)
    x = np.random.default_rng(5).standard_normal((1, 16, d)).astype("float32")
    out = tl(tp.to_tensor(x)).numpy()[0]
    np.testing.assert_allclose(out, jl(jp.to_tensor(x)).numpy()[0],
                               rtol=1e-4, atol=1e-5)
    zero_rows = np.sum(np.all(np.abs(out) < 1e-6, axis=-1))
    assert zero_rows >= 10
    # capacity 1 an expert: one token kept for each expert routed to
    used = len(set(tl.last_gate_idx.numpy().reshape(-1).tolist()))
    share = moe_layer.dropped_share(tl.last_gate_idx, 2, 0.01)
    assert share == pytest.approx(1 - used / 16)
