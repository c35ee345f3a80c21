"""quantization/ in the port against the reference: fake quant-dequant
and its straight-through gradient, the observers, QAT, PTQ and
``convert(to_int8=True)`` with its refusals
(``paddle_tpu_torch/quantization/``; reference
``paddle_tpu/quantization/`` and its tests ``tests/test_quantization.py``,
``tests/test_int8_serving.py``).

The same numpy inputs and weights go through both packages.
Tolerances: fake quant-dequant, its gradient, ``quant_tensor`` and every
observer's scale (KL's threshold included) bit-equal; QAT losses rtol
1e-5 (float32 matmuls in two libraries); an int8 model's output within
one activation quantum of the reference's (``_quantum``: an input's
rounding may flip where the two libraries' float32 products differ in
the last bit), its first layer bit-equal.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jp
from paddle_tpu import quantization as JQ
import paddle_tpu_torch as tp
from paddle_tpu_torch import quantization as TQ


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _cross(jnet, tnet):
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 24),
                         nn.ReLU(), nn.Linear(24, 8))


def _convnet(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                         nn.Conv2D(8, 8, 3, stride=2, padding=1), nn.ReLU(),
                         nn.Flatten(), nn.Linear(8 * 4 * 4, 16))


def _pair(build, seed=3):
    jp.seed(seed)
    jnet = build(jp)
    tnet = build(tp)
    _cross(jnet, tnet)
    return jnet, tnet


# -- functional -------------------------------------------------------------

@pytest.mark.parametrize("bits,axis", [(8, None), (4, None), (8, 1),
                                       (4, 0)])
def test_fake_quant_dequant_and_ste_bit_equal(bits, axis):
    rng = np.random.default_rng(bits + (axis or 0))
    x = (rng.standard_normal((6, 5)) * 2).astype(np.float32)
    if axis is None:
        scale = np.float32(1.5)
    else:
        scale = (np.abs(x).max(axis=1 - axis) * 0.7).astype(np.float32)
    g = rng.standard_normal((6, 5)).astype(np.float32)

    def jf(a):
        return jnp.sum(JQ.fake_quant_dequant(a, jnp.asarray(scale), bits,
                                             axis) * g)
    j_out = np.asarray(JQ.fake_quant_dequant(jnp.asarray(x),
                                             jnp.asarray(scale), bits, axis))
    j_grad = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(scale, requires_grad=True)
    out = TQ.fake_quant_dequant(xt, st, bits, axis)
    (out * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(out.detach().numpy(), j_out)
    assert np.array_equal(xt.grad.numpy(), j_grad)
    assert st.grad is None or not st.grad.any()   # scale gets none
    # saturated elements get no gradient
    s = np.broadcast_to(scale if axis is None else np.expand_dims(
        scale, 1 - axis), x.shape)
    assert not xt.grad.numpy()[np.abs(x) > s].any()


@pytest.mark.parametrize("bits", [8, 16])
def test_quant_and_dequant_tensor_bit_equal(bits):
    x = np.random.default_rng(bits).standard_normal(257).astype(np.float32)
    q_ref = np.asarray(JQ.quant_tensor(jnp.asarray(x), jnp.asarray(1.25),
                                       bits))
    q = TQ.quant_tensor(torch.from_numpy(x), torch.tensor(1.25), bits)
    assert q.numpy().dtype == q_ref.dtype
    assert np.array_equal(q.numpy(), q_ref)
    d_ref = np.asarray(JQ.dequant_tensor(q_ref, 1.25, bits))
    assert np.array_equal(TQ.dequant_tensor(q, 1.25, bits).numpy(), d_ref)


# -- observers ----------------------------------------------------------------

def _batches(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * (1 + i)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("name,kw", [
    ("AbsmaxObserver", {}), ("AbsmaxObserver", {"quant_axis": 1}),
    ("MovingAverageAbsmaxObserver", {"moving_rate": 0.9})])
def test_observer_scales_bit_equal(name, kw):
    jo, to = getattr(JQ, name)(**kw), getattr(TQ, name)(**kw)
    for b in _batches(3, (8, 6)):
        jo(jp.to_tensor(b))
        assert to(tp.to_tensor(b)).numpy() is not None
    assert np.array_equal(to.scales().numpy(), np.asarray(
        jo.scales().numpy()))


def test_kl_observer_threshold_bit_equal():
    # 3 batches of 90k: the reservoir fills, samples, then replaces
    jo, to = JQ.KLObserver(), TQ.KLObserver()
    data = _batches(3, (90, 1000), seed=5)
    data[1][0, 0] = 400.0                     # an outlier
    for b in data:
        jo(jp.to_tensor(b))
        to(tp.to_tensor(b))
    assert np.array_equal(to._samples, jo._samples)
    s = float(to.scales().numpy())
    assert s == float(np.asarray(jo.scales().numpy()))
    assert 0 < s < 50


def test_fake_quanter_layer_ema_bit_equal():
    jq = JQ.FakeQuanterWithAbsMaxObserverLayer(moving_rate=0.9)
    tq = TQ.FakeQuanterWithAbsMaxObserverLayer(moving_rate=0.9)
    assert not tq._updated
    for b in _batches(3, (4, 5), seed=9):
        j_out = jq(jp.to_tensor(b)).numpy()
        t_out = tq(tp.to_tensor(b)).numpy()
        assert np.array_equal(t_out, j_out)
    assert tq._updated
    for k in ("_scale", "_state", "_accum"):
        assert np.array_equal(getattr(tq, k).numpy(),
                              np.asarray(getattr(jq, k).numpy()))


def test_quant_config_lookup_order():
    net = _mlp(tp)
    a, b, c, d = (TQ.QuanterFactory(TQ.AbsmaxObserver) for _ in range(4))
    cfg = TQ.QuantConfig(activation=a, weight=a)
    cfg.add_type_config(tp.nn.Linear, activation=b)
    cfg.add_name_config("2", activation=c)
    cfg.add_layer_config(net[4], activation=d)
    got = [cfg._get_config_by_layer(net[i], str(i)).activation
           for i in (0, 2, 4)]
    assert got == [b, c, d]
    assert cfg._get_config_by_layer(net[1], "1") is cfg._global_config
    assert cfg._is_quantifiable(net[0]) and not cfg._is_quantifiable(net[1])
    assert cfg._is_quantifiable(tp.nn.Conv1D(2, 2, 1))


# -- QAT ----------------------------------------------------------------------

def test_qat_mlp_losses_then_convert():
    jnet, tnet = _pair(_mlp)
    out = {}
    for pkg, net, name in ((jp, jnet, "jax"), (tp, tnet, "torch")):
        q = pkg.quantization.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
        qnet = pkg.quantization.QAT(pkg.quantization.QuantConfig(
            activation=q, weight=q)).quantize(net)
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=qnet.parameters())
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(5):
            x = rng.standard_normal((8, 16)).astype(np.float32)
            y = rng.standard_normal((8, 8)).astype(np.float32)
            loss = pkg.mean((qnet(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        qnet.eval()
        conv = pkg.quantization.convert(qnet)
        xe = np.random.default_rng(1).standard_normal((4, 16)).astype(
            np.float32)
        out[name] = dict(losses=losses,
                         y=np.asarray(conv(pkg.to_tensor(xe)).numpy()),
                         sd={k: np.asarray(v.numpy())
                             for k, v in conv.state_dict().items()})
    np.testing.assert_allclose(out["torch"]["losses"], out["jax"]["losses"],
                               rtol=1e-5)
    assert out["torch"]["losses"][-1] < out["torch"]["losses"][0]
    assert sorted(out["torch"]["sd"]) == sorted(out["jax"]["sd"])
    assert "0.weight_scale" in out["torch"]["sd"]
    np.testing.assert_allclose(out["torch"]["y"], out["jax"]["y"],
                               rtol=1e-4, atol=1e-4)


# -- PTQ -> int8 --------------------------------------------------------------

def _ptq(pkg, net, calib):
    Q = pkg.quantization
    cfg = Q.QuantConfig(activation=Q.QuanterFactory(Q.KLObserver),
                        weight=Q.QuanterFactory(Q.AbsmaxObserver))
    ptq = Q.PTQ(cfg)
    observed = ptq.quantize(net)
    for b in calib:
        observed(pkg.to_tensor(b))
    q = ptq.convert(observed, to_int8=True)
    q.eval()
    return q


def _quantum(q):
    """One activation quantum of every int8 layer, times the largest
    dequantized weight and the fan-in (an input's rounding flip through
    that layer), summed over the layers."""
    tot = 0.0
    for s in q.sublayers():
        if isinstance(s, (TQ.QuantizedLinear, TQ.QuantizedConv2D)):
            wmax = float(s.w_scale.numpy().max())
            tot += float(s.act_scale.numpy()) / 127 * wmax * 4
    return tot


@pytest.mark.parametrize("build,shape", [(_mlp, (6, 16)),
                                         (_convnet, (2, 3, 8, 8))],
                         ids=["mlp", "convnet"])
def test_ptq_int8_against_reference(build, shape):
    jnet, tnet = _pair(build)
    jnet.eval()
    tnet.eval()
    calib = _batches(3, shape, seed=2)
    jq, tq = _ptq(jp, jnet, calib), _ptq(tp, tnet, calib)
    kinds = [type(s).__name__ for s in tq.sublayers()
             if type(s).__name__.startswith("Quantized")]
    assert kinds == [type(s).__name__ for s in jq.sublayers()
                     if type(s).__name__.startswith("Quantized")]
    jsd = {k: np.asarray(v.numpy()) for k, v in jq.state_dict().items()}
    tsd = {k: v.numpy() for k, v in tq.state_dict().items()}
    assert sorted(jsd) == sorted(tsd)
    # the weights' int8 values and scales, and the first layer's
    # activation scale (the same calibration data), bit for bit
    for k in jsd:
        if k.endswith(("qweight", "w_scale")) or k == "0.act_scale":
            assert np.array_equal(tsd[k], jsd[k]), k
    x = _batches(1, shape, seed=8)[0]
    want = np.asarray(jq(jp.to_tensor(x)).numpy())
    got = tq(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_quantum(tq))
    # the reference's buffers crossed into the port's int8 model: the
    # first layer bit-equal, the whole within one quantum
    tq.set_state_dict(jsd)
    got = tq(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_quantum(tq))
    if build is _mlp:
        assert np.array_equal(tq[0](tp.to_tensor(x)).numpy(),
                              np.asarray(jq[0](jp.to_tensor(x)).numpy()))
    # the conv's float weight left the state: int8 only
    assert not any(k.endswith("_conv.weight") for k in tsd)


def test_quantized_linear_routes_on_the_cpu():
    rng = np.random.default_rng(0)
    for M, K, N in ((3, 5, 7), (64, 2048, 1000)):
        xq = torch.from_numpy(rng.integers(-127, 128, (M, K), np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (K, N), np.int8))
        acc = TQ.quantized_layers.int8_product(xq, w)
        assert acc.dtype == torch.int32
        assert torch.equal(acc, (xq.double() @ w.double()).to(torch.int32))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_freeze_refusals_match_the_reference():
    # no calibration: an all-zero activation scale
    msgs = []
    for pkg in (jp, tp):
        net = _mlp(pkg)
        ptq = pkg.quantization.PTQ()
        observed = ptq.quantize(net)
        msgs.append(_message(lambda: ptq.convert(observed, to_int8=True)))
    assert msgs[0] == msgs[1] and "calibration" in msgs[1]
    # an untrained QAT model: the quanters never observed data
    msgs = []
    for pkg in (jp, tp):
        Q = pkg.quantization
        cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMaxObserver(),
                            weight=Q.FakeQuanterWithAbsMaxObserver())
        net = _mlp(pkg)
        net.train()
        qm = Q.QAT(cfg).quantize(net)
        msgs.append(_message(lambda: Q.QAT(cfg).convert(qm, to_int8=True)))
    assert msgs[0] == msgs[1] and "never observed" in msgs[1]


def test_per_channel_act_scale_falls_back_as_the_reference():
    outs, warned = {}, {}
    jnet, tnet = _pair(lambda pkg: pkg.nn.Sequential(
        pkg.nn.Conv2D(3, 4, 3, padding=1)), seed=7)
    X = np.random.default_rng(4).standard_normal((4, 3, 8, 8)).astype(
        np.float32)
    for pkg, net, name in ((jp, jnet, "jax"), (tp, tnet, "torch")):
        Q = pkg.quantization
        net.eval()
        cfg = Q.QuantConfig(
            activation=Q.QuanterFactory(Q.AbsmaxObserver, quant_axis=1),
            weight=Q.QuanterFactory(Q.AbsmaxObserver))
        ptq = Q.PTQ(cfg)
        observed = ptq.quantize(net)
        observed(pkg.to_tensor(X))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            frozen = ptq.convert(observed, to_int8=True)
        warned[name] = [str(m.message) for m in w
                        if "falls back" in str(m.message)]
        frozen.eval()
        outs[name] = np.asarray(frozen(pkg.to_tensor(X)).numpy())
        assert not any(type(s).__name__.startswith("Quantized")
                       for s in frozen.sublayers())
    assert warned["torch"] == warned["jax"] and len(warned["torch"]) == 1
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5,
                               atol=1e-5)


def test_qat_checkpoint_roundtrip_still_freezes():
    Q = TQ
    cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMaxObserver(),
                        weight=Q.FakeQuanterWithAbsMaxObserver())
    net = _mlp(tp)
    net.train()
    qmodel = Q.QAT(cfg).quantize(net)
    rng = np.random.default_rng(2)
    for _ in range(3):
        qmodel(tp.to_tensor(rng.standard_normal((8, 16)).astype(np.float32)))
    sd = qmodel.state_dict()
    net2 = _mlp(tp)
    net2.train()
    qmodel2 = Q.QAT(cfg).quantize(net2)
    qmodel2.set_state_dict(sd)
    qmodel2.eval()
    frozen = Q.QAT(cfg).convert(qmodel2, to_int8=True)
    assert sum(isinstance(s, Q.QuantizedLinear)
               for s in frozen.sublayers()) == 3


def test_public_names_are_the_reference_s():
    assert TQ.__all__ == JQ.__all__
    assert all(hasattr(TQ, n) for n in TQ.__all__)
