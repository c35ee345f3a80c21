"""The port's optimizers and LR schedules against the JAX package's.

Each optimizer runs 3 steps on the same parameters and gradients in both
packages (f32; the parameters after every step within 1e-6 + 1e-5
relative, the accumulators compared by parameter order since parameter
names come from per-package counters).  Every scheduler's values over 20
steps are equal to 1e-12.  A state_dict round trip resumes bit-equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


SHAPES = [(4, 3), (3,), (2, 2)]


def _params(paddle, rng):
    init = paddle.nn.initializer.Assign
    return [paddle.create_parameter(list(s), "float32",
                                    default_initializer=init(
                                        rng.standard_normal(s).astype(
                                            np.float32)))
            for s in SHAPES]


def _grads(rng):
    return [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
            for _ in range(3)]


OPTS = {
    "SGD": dict(learning_rate=0.1),
    "SGD-wd": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "Momentum-nesterov": dict(learning_rate=0.1, momentum=0.9,
                              use_nesterov=True),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "Adam": dict(learning_rate=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
    "AdamW-decay-fn": dict(learning_rate=0.01, weight_decay=0.1,
                           apply_decay_param_fun="first"),
    "AdamW-clip": dict(learning_rate=0.01, weight_decay=0.1,
                       grad_clip="global"),
    "Adamax": dict(learning_rate=0.01),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSProp-centered": dict(learning_rate=0.01, centered=True),
    "Adadelta": dict(learning_rate=1.0),
    "Lamb": dict(learning_rate=0.01),
    "LarsMomentum": dict(learning_rate=0.1, exclude_from_weight_decay=[]),
}


def _make(paddle, key, params, lr=None):
    kw = dict(OPTS[key])
    if lr is not None:
        kw["learning_rate"] = lr
    if kw.get("apply_decay_param_fun") == "first":
        first = params[0].name
        kw["apply_decay_param_fun"] = lambda name: name == first
    if kw.get("grad_clip") == "global":
        kw["grad_clip"] = paddle.nn.ClipGradByGlobalNorm(0.5)
    return getattr(paddle.optimizer, key.split("-")[0])(parameters=params,
                                                        **kw)


def _accs(opt, params):
    """{accumulator: [value per parameter, in order]}."""
    sd = opt.state_dict()
    out = {}
    for p in params:
        for k, v in sd.items():
            if isinstance(k, str) and k.startswith(p.name + "_"):
                out.setdefault(k[len(p.name) + 1:], []).append(v.numpy())
    return out


def _trajectory(paddle, key, lr=None):
    rng = np.random.default_rng(3)
    params = _params(paddle, rng)
    opt = _make(paddle, key, params, lr)
    traj = []
    for gs in _grads(rng):
        for p, g in zip(params, gs):
            p.grad = paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
        assert all(p.grad is None for p in params)
        traj.append([p.numpy().copy() for p in params])
    return traj, _accs(opt, params), params


@pytest.mark.parametrize("key", sorted(OPTS))
def test_optimizer_matches_the_reference(key):
    jt, jacc, _ = _trajectory(jpaddle, key)
    tt, tacc, tparams = _trajectory(tpaddle, key)
    for step, (a, b) in enumerate(zip(tt, jt)):
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} step {step} p{k}")
    assert sorted(tacc) == sorted(jacc)
    for name in jacc:
        for x, y in zip(tacc[name], jacc[name]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} {name}")
    # the update is written into each parameter's own storage: every
    # parameter is still a leaf that requires grad
    assert all(p.is_leaf and not p.stop_gradient for p in tparams)


def test_adamw_arithmetic_is_the_references():
    """p - lr m̂/(√v̂ + ε) - lr wd p, f32 moments, not torch.optim's."""
    p = tpaddle.create_parameter(
        [3], "float32", default_initializer=tpaddle.nn.initializer.Assign(
            np.array([1.0, -2.0, 0.5], np.float32)))
    opt = tpaddle.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                  parameters=[p], epsilon=1e-8)
    g = np.array([0.3, -0.1, 2.0], np.float32)
    p.grad = tpaddle.to_tensor(g)
    w0 = p.numpy().copy()
    opt.step()
    m = 0.1 * g
    v = 0.001 * g * g
    mh, vh = m / 0.1, v / 0.001
    want = w0 - 0.1 * mh / (np.sqrt(vh) + 1e-8) - 0.1 * 0.5 * w0
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)


def test_state_dict_round_trip_resumes_bit_equal():
    rng = np.random.default_rng(8)
    grads = _grads(rng)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]

    def build():
        ps = [tpaddle.create_parameter(
            list(s), "float32",
            default_initializer=tpaddle.nn.initializer.Assign(a))
            for s, a in zip(SHAPES, init)]
        sched = tpaddle.optimizer.lr.StepDecay(0.01, 1, 0.5)
        return ps, tpaddle.optimizer.Adam(learning_rate=sched, parameters=ps)

    def step(ps, opt, gs):
        for p, g in zip(ps, gs):
            p.grad = tpaddle.to_tensor(g)
        opt.step()
        opt._lr.step()

    a, opt_a = build()
    step(a, opt_a, grads[0])
    sd = opt_a.state_dict()
    b, opt_b = build()
    for pb, pa in zip(b, a):
        pb.set_value(pa)
    opt_b.set_state_dict(sd)
    assert opt_b._lr.last_lr == opt_a._lr.last_lr
    step(a, opt_a, grads[1])
    step(b, opt_b, grads[1])
    for pa, pb in zip(a, b):
        assert torch.equal(pa._t, pb._t)


SCHEDS = {
    "NoamDecay": (64, 5), "PiecewiseDecay": ([3, 8], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": (0.5, 0.1), "InverseTimeDecay": (0.5, 0.1),
    "PolynomialDecay": (0.5, 10), "PolynomialDecay-cycle": (0.5, 6),
    "LinearWarmup": (0.5, 5, 0.0, 0.5),
    "LinearWarmup-inner": ("inner", 4, 0.0, 0.5),
    "ExponentialDecay": (0.5, 0.9), "MultiStepDecay": (0.5, [4, 9]),
    "StepDecay": (0.5, 3), "LambdaDecay": (0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": (0.5, lambda e: 0.9),
    "CosineAnnealingDecay": (0.5, 10), "OneCycleLR": (0.5, 20),
    "CyclicLR": (0.01, 0.1, 4), "CyclicLR-tri2": (0.01, 0.1, 3),
}
SCHED_KW = {"PolynomialDecay-cycle": dict(cycle=True),
            "CyclicLR-tri2": dict(mode="triangular2")}


def _sched(paddle, key):
    lr = paddle.optimizer.lr
    args = list(SCHEDS[key])
    if args[0] == "inner":
        args[0] = lr.CosineAnnealingDecay(0.5, 8)
    return getattr(lr, key.split("-")[0])(*args, **SCHED_KW.get(key, {}))


@pytest.mark.parametrize("key", sorted(SCHEDS))
def test_scheduler_values_match_the_reference(key):
    vals = []
    for paddle in (jpaddle, tpaddle):
        s = _sched(paddle, key)
        seq = []
        for _ in range(20):
            seq.append(s())
            s.step()
        vals.append(seq)
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12, atol=1e-12)


def test_reduce_on_plateau_matches_the_reference():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]
    vals = []
    for paddle in (jpaddle, tpaddle):
        s = paddle.optimizer.lr.ReduceOnPlateau(0.5, patience=2,
                                                cooldown=1)
        seq = []
        for m in metrics:
            s.step(paddle.to_tensor(m))
            seq.append(s())
        vals.append(seq)
    assert vals[0] == vals[1]


def test_scheduler_drives_the_optimizer_and_state_round_trips():
    sched = tpaddle.optimizer.lr.LinearWarmup(0.1, 4, 0.0, 0.1)
    p = tpaddle.create_parameter([2], "float32")
    opt = tpaddle.optimizer.SGD(learning_rate=sched, parameters=[p])
    lrs = []
    for _ in range(5):
        lrs.append(opt.get_lr())
        sched.step()
    np.testing.assert_allclose(lrs, [0.0, 0.025, 0.05, 0.075, 0.1])
    other = tpaddle.optimizer.lr.LinearWarmup(0.1, 4, 0.0, 0.1)
    other.set_state_dict(sched.state_dict())
    assert other() == sched() and other.last_epoch == sched.last_epoch
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
