"""static/ in the port against the reference: Program recording, the
Executor's replay and training, the control-flow ops, the inference
export, the long tail (``paddle_tpu_torch/static/``; reference
``paddle_tpu/static/``, its tests ``tests/test_static_program.py``,
``tests/test_control_flow.py`` and the static cases of
``tests/test_api_breadth.py``).

Each case runs the reference's program through both packages on the
same numpy feeds; the parameters the programs create cross from the
reference's program to the port's as numpy (in capture order).  Losses
and fetches agree to rtol 1e-5 (float32 over tens of steps: 1e-4), and
every assertion of the reference's test holds for the port.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import static as jstatic
from paddle_tpu_torch import static as tstatic


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()
    jp.disable_static()


def _linreg_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, 8)).astype("float32")
    w = rng.standard_normal((8, 1)).astype("float32")
    ys = (xs @ w + 0.1).astype("float32")
    return xs, ys


def _sync(jprog, tprog):
    """The reference program's trainable captures into the port's, in
    capture order."""
    jc = [t for t in jprog._captured() if not t.stop_gradient]
    tc = [t for t in tprog._captured() if not t.stop_gradient]
    assert [tuple(t.shape) for t in jc] == [tuple(t.shape) for t in tc]
    for a, b in zip(jc, tc):
        b._set_array(torch.as_tensor(np.array(a._array)))


def _fc_program(pkg, static, opt_fn, hidden=16):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        pkg.seed(0)
        x = static.data("x", [None, 8])
        y = static.data("y", [None, 1])
        h = static.nn.fc(x, hidden, activation="relu")
        pred = static.nn.fc(h, 1)
        loss = pkg.mean((pred - y) ** 2)
        opt = opt_fn(pkg)
        opt.minimize(loss)
    return main, startup, loss, opt


def test_static_train_loop_converges():
    sgd = lambda pkg: pkg.optimizer.SGD(learning_rate=0.05)  # noqa: E731
    jm, js, jl, _ = _fc_program(jp, jstatic, sgd)
    tm, ts, tl, _ = _fc_program(tp, tstatic, sgd)
    _sync(jm, tm)
    je, te = jstatic.Executor(), tstatic.Executor()
    je.run(js)
    te.run(ts)
    xs, ys = _linreg_data()
    jv = [float(je.run(jm, feed={"x": xs, "y": ys}, fetch_list=[jl])[0])
          for _ in range(60)]
    tv = [float(te.run(tm, feed={"x": xs, "y": ys}, fetch_list=[tl])[0])
          for _ in range(60)]
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    assert tv[-1] < tv[0] * 0.2, (tv[0], tv[-1])


def test_static_adam_engages_accumulators():
    def adam(pkg):
        return pkg.optimizer.Adam(learning_rate=0.05)
    progs = {}
    for name, pkg, static in (("j", jp, jstatic), ("t", tp, tstatic)):
        main = static.Program()
        with static.program_guard(main):
            pkg.seed(1)
            x = static.data("x", [None, 8])
            y = static.data("y", [None, 1])
            pred = static.nn.fc(x, 1)
            loss = pkg.mean((pred - y) ** 2)
            opt = adam(pkg)
            opt.minimize(loss)
        progs[name] = (main, loss, opt, static.Executor())
    _sync(progs["j"][0], progs["t"][0])
    xs, ys = _linreg_data(seed=2)
    vals = {n: [float(e.run(m, feed={"x": xs, "y": ys},
                            fetch_list=[lo])[0]) for _ in range(40)]
            for n, (m, lo, _o, e) in progs.items()}
    np.testing.assert_allclose(vals["t"], vals["j"], rtol=1e-4)
    assert vals["t"][-1] < vals["t"][0] * 0.2
    assert progs["t"][2]._accumulators  # moment buffers were made and used


def test_batch_polymorphism_and_fetch_intermediate():
    got = {}
    progs = {}
    for name, pkg, static in (("j", jp, jstatic), ("t", tp, tstatic)):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 4])
            h = static.nn.fc(x, 3, activation="relu")
            out = pkg.sum(h, axis=-1)
        progs[name] = (main, h, out, static.Executor())
    _sync(progs["j"][0], progs["t"][0])
    rng = np.random.default_rng(0)
    feeds = {bs: rng.standard_normal((bs, 4)).astype("float32")
             for bs in (32, 7, 1)}
    for name, (main, h, out, exe) in progs.items():
        for bs, xv in feeds.items():
            hv, ov = exe.run(main, feed={"x": xv}, fetch_list=[h, out])
            assert hv.shape == (bs, 3) and ov.shape == (bs,)
            got[(name, bs)] = (hv, ov)
        (t,) = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                       fetch_list=[out], return_numpy=False)
        assert hasattr(t, "numpy")
    for bs in feeds:
        for a, b in zip(got[("j", bs)], got[("t", bs)]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pkg,static", [(jp, jstatic), (tp, tstatic)],
                         ids=["jax", "torch"])
def test_program_var_lookup_and_guard_isolation(pkg, static):
    p1, p2 = static.Program(), static.Program()
    with static.program_guard(p1):
        a = static.data("a", [None, 2])
        b = a + 1.0
        b.name = "b_out"
    with static.program_guard(p2):
        static.data("a", [None, 3])
    assert p1.var("a") is a
    assert p1.var("b_out") is b
    with pytest.raises(KeyError):
        p1.var("missing")
    assert p1.var("a").shape[-1] == 2
    assert p2.var("a").shape[-1] == 3
    assert len(p2._ops) == 0  # p2 recorded nothing from p1's build


@pytest.mark.parametrize("pkg,static", [(jp, jstatic), (tp, tstatic)],
                         ids=["jax", "torch"])
def test_missing_feed_and_duplicate_names_error(pkg, static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 2])
        _ = x * 2.0
        with pytest.raises(ValueError, match="duplicate feed"):
            static.data("x", [None, 2])
    with pytest.raises(ValueError, match="missing feeds"):
        static.Executor().run(main, feed={}, fetch_list=[x])


def test_clone_for_test_drops_optimizer():
    outs = {}
    for name, pkg, static in (("j", jp, jstatic), ("t", tp, tstatic)):
        main = static.Program()
        with static.program_guard(main):
            pkg.seed(0)
            x = static.data("x", [None, 2])
            y = static.data("y", [None, 1])
            loss = pkg.mean((static.nn.fc(x, 1) - y) ** 2)
            pkg.optimizer.SGD(0.1).minimize(loss)
        test_prog = main.clone(for_test=True)
        assert main._opt is not None and test_prog._opt is None
        outs[name] = (main, test_prog, loss)
    _sync(outs["j"][0], outs["t"][0])
    vals = {}
    for name, (main, test_prog, loss) in outs.items():
        exe = (jstatic if name == "j" else tstatic).Executor()
        params = [t for t in main._captured() if not t.stop_gradient]
        before = [p.numpy().copy() for p in params]
        vals[name] = exe.run(test_prog,
                             feed={"x": np.ones((3, 2), "float32"),
                                   "y": np.ones((3, 1), "float32")},
                             fetch_list=[loss])[0]
        for p, b in zip(params, before):
            np.testing.assert_array_equal(p.numpy(), b)
    np.testing.assert_allclose(vals["t"], vals["j"], rtol=1e-6)


def test_eager_mode_unaffected_after_disable():
    for pkg in (jp, tp):
        pkg.enable_static()
        pkg.disable_static()
        assert pkg.in_dynamic_mode()
        t = pkg.to_tensor(np.ones((2, 2), "float32"), stop_gradient=False)
        (t * 3).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.full((2, 2), 3.0))
    from paddle_tpu_torch.core import tensor as tensor_mod
    assert tensor_mod._STATIC_RECORD_HOOK[0] is None


def _mlp_infer_program(pkg, static, shape, seed):
    main = static.Program()
    with static.program_guard(main):
        pkg.seed(seed)
        x = static.data("x", shape)
        h = static.nn.fc(x, 8, activation="relu")
        out = static.nn.fc(h, 2)
    return main, x, out


def test_save_load_inference_model_roundtrip(tmp_path):
    jm, _, jo = _mlp_infer_program(jp, jstatic, [4, 6], 3)
    tm, tx, to = _mlp_infer_program(tp, tstatic, [4, 6], 3)
    _sync(jm, tm)
    xs = np.random.default_rng(5).standard_normal((4, 6)).astype("float32")
    ref, = jstatic.Executor().run(jm, feed={"x": xs}, fetch_list=[jo])
    exe = tstatic.Executor()
    mine, = exe.run(tm, feed={"x": xs}, fetch_list=[to])
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6)
    prefix = str(tmp_path / "static_model")
    tstatic.save_inference_model(prefix, [tx], [to], exe, program=tm)
    loaded = tstatic.load_inference_model(prefix)
    got = loaded(xs)
    got = got.numpy() if hasattr(got, "numpy") else got[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_save_inference_model_dynamic_batch(tmp_path):
    jm, _, jo = _mlp_infer_program(jp, jstatic, [None, 6], 7)
    tm, tx, to = _mlp_infer_program(tp, tstatic, [None, 6], 7)
    _sync(jm, tm)
    exe = tstatic.Executor()
    prefix = str(tmp_path / "dyn_model")
    tstatic.save_inference_model(prefix, [tx], [to], exe, program=tm)
    loaded = tstatic.load_inference_model(prefix)
    rng = np.random.default_rng(9)
    for batch in (1, 3, 8):
        xs = rng.standard_normal((batch, 6)).astype("float32")
        ref, = jstatic.Executor().run(jm, feed={"x": xs}, fetch_list=[jo])
        got = loaded(xs)
        got = got.numpy() if hasattr(got, "numpy") else got[0].numpy()
        assert got.shape == (batch, 2)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with open(prefix + ".meta", "rb") as f:
        meta = pickle.load(f)
    assert meta["input_specs"][0][0] == [None, 6]


def test_save_inference_model_two_dynamic_feeds(tmp_path):
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [None, 6])
        y = tstatic.data("y", [None, 6])
        out = x * 2.0 + y
    exe = tstatic.Executor()
    prefix = str(tmp_path / "dyn2_model")
    tstatic.save_inference_model(prefix, [x, y], [out], exe, program=main)
    loaded = tstatic.load_inference_model(prefix)
    rng = np.random.default_rng(11)
    for batch in (2, 5):
        xs = rng.standard_normal((batch, 6)).astype("float32")
        ys = rng.standard_normal((batch, 6)).astype("float32")
        got = loaded(xs, ys)
        got = got.numpy() if hasattr(got, "numpy") else got[0].numpy()
        np.testing.assert_allclose(got, xs * 2.0 + ys, rtol=1e-6)


def _bn_program(pkg, static):
    main = static.Program()
    with static.program_guard(main):
        pkg.seed(0)
        x = static.data("x", [None, 4])
        bn = pkg.nn.BatchNorm1D(4)
        bn.train()
        y = bn(x)
        loss = pkg.mean(y * y)
        pkg.optimizer.SGD(0.01).minimize(loss)
    return main, bn, y, loss


def test_batchnorm_running_stats_update_across_runs():
    res = {}
    for name, pkg, static in (("j", jp, jstatic), ("t", tp, tstatic)):
        main, bn, y, loss = _bn_program(pkg, static)
        exe = static.Executor()
        rng = np.random.default_rng(0)
        before = bn._mean.numpy().copy()
        for _ in range(5):
            xs = (rng.standard_normal((32, 4)) * 3 + 7).astype("float32")
            exe.run(main, feed={"x": xs}, fetch_list=[loss])
        after = bn._mean.numpy().copy()
        assert not np.allclose(before, after)
        assert np.all(after > 1.0)  # moving toward the data mean ~7
        test_prog = main.clone(for_test=True)
        exe.run(test_prog, feed={"x": np.ones((8, 4), "float32")},
                fetch_list=[y])
        np.testing.assert_array_equal(bn._mean.numpy(), after)
        res[name] = (after, bn._variance.numpy().copy())
    for a, b in zip(res["j"], res["t"]):
        np.testing.assert_allclose(b, a, rtol=1e-5)


def test_batchnorm_build_does_not_corrupt_stats_and_var_scale():
    for pkg, static in ((jp, jstatic), (tp, tstatic)):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 4])
            bn = pkg.nn.BatchNorm1D(4)
            bn.train()
            _y = bn(x)
        np.testing.assert_array_equal(bn._mean.numpy(),
                                      np.zeros(4, "float32"))
        np.testing.assert_array_equal(bn._variance.numpy(),
                                      np.ones(4, "float32"))
        exe = static.Executor()
        xs = np.random.default_rng(0).standard_normal((32, 4)) \
            .astype("float32")
        exe.run(main, feed={"x": xs}, fetch_list=[_y])
        want_var = 0.9 * 1.0 + 0.1 * xs.var(0) * (32 / 31)
        np.testing.assert_allclose(bn._variance.numpy(), want_var,
                                   rtol=1e-5, atol=1e-5)


def test_batchnorm_invoked_twice_chains_updates():
    for pkg, static in ((jp, jstatic), (tp, tstatic)):
        main = static.Program()
        with static.program_guard(main):
            xa = static.data("a", [None, 2])
            xb = static.data("b", [None, 2])
            bn = pkg.nn.BatchNorm1D(2)
            bn.train()
            _ = bn(xa)
            _out = bn(xb)
        exe = static.Executor()
        a = np.full((8, 2), 1.0, "float32")
        b = np.full((8, 2), 5.0, "float32")
        exe.run(main, feed={"a": a, "b": b}, fetch_list=[_out])
        # chained: m1 = 0.9*0 + 0.1*1 = 0.1; m2 = 0.9*0.1 + 0.1*5 = 0.59
        np.testing.assert_allclose(bn._mean.numpy(), [0.59, 0.59],
                                   rtol=1e-5, atol=1e-6)


def test_static_llama_step_equals_eager():
    """bench.py's model family in static mode at a small size: the
    Executor's first step gives the eager step's loss and every grad bit
    for bit, and its first three losses the eager ones; the first loss
    agrees with the reference's static program."""
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.models import llama as tl
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=32)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype("int64")
    labels = rng.integers(0, 128, (2, 16)).astype("int64")
    jnet = jl.LlamaForCausalLM(jl.LlamaConfig(**kw))
    state = {k: v.numpy() for k, v in jnet.state_dict().items()}
    cfg = tl.LlamaConfig(dtype=torch.float32, **kw)

    def net():
        n = tl.LlamaForCausalLM(cfg)
        n.set_state_dict(state)
        return n

    enet = net()
    eopt = tp.optimizer.AdamW(learning_rate=1e-3,
                              parameters=enet.parameters())
    eager_losses, eager_grads = [], None
    for k in range(3):
        loss, _ = enet(tp.to_tensor(ids), labels=tp.to_tensor(labels))
        loss.backward()
        if k == 0:
            eager_grads = [p.grad._t.clone() for p in enet.parameters()
                           if not p.stop_gradient]
        eopt.step()
        eopt.clear_grad()
        eager_losses.append(loss._t.clone())

    snet = net()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        sids = tstatic.data("ids", [2, 16], "int64")
        slab = tstatic.data("labels", [2, 16], "int64")
        loss, _ = snet(sids, slab)
        opt = tp.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=snet.parameters())
        opt.minimize(loss)
    assert opt._parameter_list and not loss._t.requires_grad
    exe = tstatic.Executor()
    grads = []
    orig_step = opt.step

    def step():
        if not grads:
            grads.extend(p.grad._t.clone() for p in snet.parameters()
                         if not p.stop_gradient)
        orig_step()
    opt.step = step
    losses = [exe.run(main, feed={"ids": ids, "labels": labels},
                      fetch_list=[loss], return_numpy=False)[0]._t
              for _ in range(3)]
    for a, b in zip(losses, eager_losses):
        assert torch.equal(a, b)
    assert len(grads) == len(eager_grads)
    for a, b in zip(grads, eager_grads):
        assert torch.equal(a, b)
    # the reference's static program on the same weights and batch
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain):
        jids = jstatic.data("ids", [2, 16], "int64")
        jlab = jstatic.data("labels", [2, 16], "int64")
        jloss, _ = jnet(jids, jlab)
    ref, = jstatic.Executor().run(jmain, feed={"ids": ids,
                                               "labels": labels},
                                  fetch_list=[jloss])
    np.testing.assert_allclose(float(losses[0]), float(ref), rtol=1e-5)


# -- control flow (tests/test_control_flow.py) ------------------------------

def test_cond_eager():
    for pkg in (jp, tp):
        snn = pkg.static.nn
        x = pkg.to_tensor(3.0)
        out = snn.cond(x < 5.0, lambda: x * 2, lambda: x - 1)
        assert float(out.numpy()) == 6.0
        out = snn.cond(x > 5.0, lambda: x * 2, lambda: x - 1)
        assert float(out.numpy()) == 2.0


def _cond_f(x):
    return tp.static.nn.cond(x.sum() > 0, lambda: x * 2.0, lambda: -x)


def test_cond_traced_and_grad():
    f = tp.jit.to_static(_cond_f)
    np.testing.assert_allclose(
        f(tp.to_tensor(np.array([1.0, 2.0], np.float32))).numpy(),
        [2.0, 4.0])
    np.testing.assert_allclose(
        f(tp.to_tensor(np.array([-1.0, -2.0], np.float32))).numpy(),
        [1.0, 2.0])
    assert any("cond" in str(n.target) for n in f.program().graph.nodes)
    # gradients through cond equal the reference's lax.cond vjp
    for v, want in (([1.0, 2.0], [2.0, 2.0]), ([-1.0, -2.0], [-1.0, -1.0])):
        a = tp.to_tensor(np.array(v, np.float32), stop_gradient=False)
        _cond_f(a).sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), want)


def test_while_loop_eager():
    for pkg in (jp, tp):
        snn = pkg.static.nn
        i = pkg.to_tensor(0)
        s = pkg.to_tensor(0.0)
        i2, s2 = snn.while_loop(lambda i, s: i < 5,
                                lambda i, s: (i + 1, s + 2.0), [i, s])
        assert int(i2.numpy()) == 5 and float(s2.numpy()) == 10.0


def test_while_loop_traced():
    for pkg in (jp, tp):
        snn = pkg.static.nn

        def f(n):
            i = pkg.to_tensor(0)
            s = pkg.to_tensor(1.0)
            i, s = snn.while_loop(lambda i, s: i < n,
                                  lambda i, s: (i + 1, s * 2.0), [i, s])
            return s
        out = pkg.jit.to_static(f)(pkg.to_tensor(6))
        assert float(out.numpy()) == 64.0


def test_switch_case_eager_and_default():
    for pkg in (jp, tp):
        snn = pkg.static.nn
        fns = {1: lambda: pkg.to_tensor(10.0),
               3: lambda: pkg.to_tensor(30.0)}
        d = lambda: pkg.to_tensor(-1.0)  # noqa: E731
        assert float(snn.switch_case(pkg.to_tensor(3), fns,
                                     d).numpy()) == 30.0
        assert float(snn.switch_case(pkg.to_tensor(7), fns,
                                     d).numpy()) == -1.0


def test_switch_case_traced():
    for pkg in (jp, tp):
        snn = pkg.static.nn

        def f(idx):
            return snn.switch_case(
                idx,
                {0: lambda: pkg.to_tensor(0.0),
                 2: lambda: pkg.to_tensor(22.0)},
                default=lambda: pkg.to_tensor(99.0))
        sf = pkg.jit.to_static(f)
        assert float(sf(pkg.to_tensor(2)).numpy()) == 22.0
        assert float(sf(pkg.to_tensor(5)).numpy()) == 99.0


def test_case_first_match_wins():
    for pkg in (jp, tp):
        x = pkg.to_tensor(2.0)
        out = pkg.static.nn.case(
            [(x > 3.0, lambda: pkg.to_tensor(1.0)),
             (x > 1.0, lambda: pkg.to_tensor(2.0))],
            default=lambda: pkg.to_tensor(0.0))
        assert float(out.numpy()) == 2.0


def _early(x):
    if x.sum() > 0:
        return x
    return -x


def test_python_if_with_early_return_converts():
    for pkg in (jp, tp):
        f = pkg.jit.to_static(_early)
        np.testing.assert_allclose(
            f(pkg.to_tensor(np.array([1.0], np.float32))).numpy(), [1.0])
        np.testing.assert_allclose(
            f(pkg.to_tensor(np.array([-1.0], np.float32))).numpy(), [1.0])


# -- the long tail (tests/test_api_breadth.py) ------------------------------

def test_static_persistence_scope_shells_and_metrics(tmp_path):
    outs = {}
    for name, pkg, static in (("j", jp, jstatic), ("t", tp, tstatic)):
        pkg.enable_static()
        try:
            prog = static.Program()
            with static.program_guard(prog):
                x = static.data("x", [4, 8], "float32")
                w = static.create_parameter([8, 2], "float32")
                y = pkg.matmul(x, w)
            if name == "t":
                w._set_array(torch.as_tensor(outs["w"]))
            else:
                outs["w"] = np.asarray(w.numpy())
            exe = static.Executor()
            xin = np.random.default_rng(0).standard_normal(
                (4, 8)).astype(np.float32)
            out1 = exe.run(prog, feed={"x": xin}, fetch_list=[y])[0]
            static.save(prog, str(tmp_path / f"m{name}"))
            w._set_array(w * 0.0)
            static.load(prog, str(tmp_path / f"m{name}"))
            out2 = exe.run(prog, feed={"x": xin}, fetch_list=[y])[0]
            np.testing.assert_allclose(out1, out2, rtol=1e-6)
            with static.scope_guard(static.Scope(prog)):
                assert static.global_scope().find_var("x") is not None
            with pytest.warns(UserWarning):
                cp = static.CompiledProgram(
                    prog, build_strategy=static.BuildStrategy())
            out3 = exe.run(cp._program, feed={"x": xin}, fetch_list=[y])[0]
            np.testing.assert_allclose(out1, out3, rtol=1e-6)
            assert len(static.cpu_places(2)) == 2
            ema = static.ExponentialMovingAverage(0.5)
            ema.update([w])
            w0 = w.numpy().copy()
            w._set_array(w + 1.0)
            ema.update([w])
            with ema.apply():
                applied = w.numpy().copy()
            np.testing.assert_allclose(w.numpy(), w0 + 1.0, rtol=1e-6)
            assert not np.allclose(applied, w.numpy())
            acc = static.accuracy(
                pkg.to_tensor(np.eye(4, dtype=np.float32)),
                pkg.to_tensor(np.arange(4)))
            a = static.auc(
                pkg.to_tensor(np.array([0.1, 0.9, 0.8, 0.2], np.float32)),
                pkg.to_tensor(np.array([0, 1, 1, 0])))
            with pytest.raises(NotImplementedError, match="out of scope"):
                static.ipu_shard_guard()
            outs[name] = (out1, float(acc.numpy()), float(a.numpy()),
                          applied)
        finally:
            pkg.disable_static()
    for a, b in zip(outs["j"], outs["t"]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5)
    assert outs["t"][1] == 1.0 and outs["t"][2] == 1.0


def test_sequence_ops_pair_convention():
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    lens = np.array([3, 2], np.int64)
    res = {}
    for name, pkg in (("j", jp), ("t", tp)):
        S = pkg.static.nn
        seq = (pkg.to_tensor(vals), pkg.to_tensor(lens))
        padded, ln = S.sequence_pad(seq, 0.0)
        back = S.sequence_unpad(padded, ln)
        sm = S.sequence_softmax((pkg.to_tensor(vals[:, :1].copy()),
                                 pkg.to_tensor(lens)))
        one = (pkg.to_tensor(np.array([[1., 1.], [2., 2.]], np.float32)),
               pkg.to_tensor(np.array([1, 1], np.int64)))
        res[name] = [padded.numpy(), back[0].numpy(), sm[0].numpy(),
                     S.sequence_pool(seq, "max").numpy(),
                     S.sequence_pool(seq, "sqrt").numpy(),
                     S.sequence_first_step(seq).numpy(),
                     S.sequence_last_step(seq).numpy(),
                     S.sequence_reverse(seq)[0].numpy(),
                     S.sequence_concat([seq, seq])[1].numpy(),
                     S.sequence_expand_as(one, seq)[0].numpy(),
                     S.sequence_enumerate((pkg.to_tensor(
                         np.arange(5, dtype=np.int64)),
                         pkg.to_tensor(lens)), 2)[0].numpy()]
        with pytest.raises(ValueError, match="lengths sum"):
            S.sequence_pool((pkg.to_tensor(vals),
                             pkg.to_tensor(np.array([9, 9]))), "max")
    for a, b in zip(res["j"], res["t"]):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    np.testing.assert_array_equal(res["t"][3], [[4, 5], [8, 9]])


def test_static_rnn_replays_block():
    outs = []
    for pkg in (jp, tp):
        S = pkg.static.nn
        pkg.enable_static()
        try:
            x = np.ones((4, 2, 3), np.float32)
            rnn = S.StaticRNN()
            with rnn.step():
                word = rnn.step_input(pkg.to_tensor(x))
                prev = rnn.memory(shape=[-1, 3],
                                  batch_ref=pkg.to_tensor(x[0]))
                hidden = pkg.add(prev, word)
                rnn.update_memory(prev, hidden)
                rnn.step_output(hidden)
            out = rnn()
        finally:
            pkg.disable_static()
        outs.append(out.numpy())
    assert outs[1].shape == (4, 2, 3)
    np.testing.assert_allclose(outs[1][:, 0, 0], [1, 2, 3, 4])
    np.testing.assert_allclose(outs[1], outs[0])


def test_sequence_conv_pool_gradients_match():
    ln_np = np.array([3, 2], np.int64)
    xs = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    grads = {}
    for name, pkg in (("j", jp), ("t", tp)):
        S = pkg.static.nn
        ln = pkg.to_tensor(ln_np)
        out = {}
        for kind in ("average", "max"):
            x = pkg.to_tensor(xs, stop_gradient=False)
            y = S.sequence_pool((x, ln), kind)
            pkg.sum(y * y).backward()
            out[kind] = x.grad.numpy()
        x = pkg.to_tensor(xs, stop_gradient=False)
        y = S.sequence_softmax((x, ln))[0]
        pkg.sum(y * y).backward()
        out["softmax"] = x.grad.numpy()
        grads[name] = out
    for k in grads["j"]:
        np.testing.assert_allclose(grads["t"][k], grads["j"][k], rtol=1e-5,
                                   atol=1e-6)


def test_gradients_and_static_amp_names():
    x = tp.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    (g,) = tstatic.gradients([(x * x).sum()], [x])
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    assert tstatic.amp is tp.amp.auto_cast
    assert "save_inference_model" in tstatic.__all__


def _amp_fc_program(pkg, static):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        pkg.seed(0)
        x = static.data("x", [None, 8])
        y = static.data("y", [None, 1])
        with static.amp(dtype="bfloat16"):
            h = static.nn.fc(x, 16, activation="relu")
            pred = static.nn.fc(h, 1)
        loss = pkg.mean((pred.astype("float32") - y) ** 2)
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss, pred


def test_static_amp_program_reads_feeds_and_trains():
    """An fc program built under ``static.amp``, fed a new batch each
    run: the port's Executor equals eager ``auto_cast`` over the same
    layers bit for bit (the casts replay as part of each op, on the fed
    and the live values), and the reference's Executor to bf16's
    rounding (rtol 2e-2, atol 1e-2: its replay runs the white-list ops
    at the inputs' float32)."""
    jm, js, jl, jpred = _amp_fc_program(jp, jstatic)
    tm, ts, tl, tpred = _amp_fc_program(tp, tstatic)
    _sync(jm, tm)
    caps = [t for t in tm._captured() if not t.stop_gradient]
    init = [t._t.clone() for t in caps]
    layers = [tp.nn.Linear(8, 16), tp.nn.Linear(16, 1)]
    params = [p for layer in layers for p in layer.parameters()]
    for p, v in zip(params, init):
        p._set_array(v.clone())
    opt = tp.optimizer.SGD(learning_rate=0.05, parameters=params)
    je, te = jstatic.Executor(), tstatic.Executor()
    je.run(js)
    te.run(ts)
    rng = np.random.default_rng(0)
    preds = []
    for _ in range(3):
        xs = rng.standard_normal((4, 8)).astype("float32")
        ys = rng.standard_normal((4, 1)).astype("float32")
        jv = je.run(jm, feed={"x": xs, "y": ys}, fetch_list=[jl, jpred])
        tv = te.run(tm, feed={"x": xs, "y": ys}, fetch_list=[tl, tpred],
                    return_numpy=False)
        with tp.amp.auto_cast(dtype="bfloat16"):
            pred = layers[1](tp.nn.functional.relu(
                layers[0](tp.to_tensor(xs))))
        loss = tp.mean((pred.astype("float32") - tp.to_tensor(ys)) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        assert torch.equal(tv[0]._t, loss._t)
        assert torch.equal(tv[1]._t, pred._t)
        preds.append(tv[1]._t.float().numpy())
        np.testing.assert_allclose(float(tv[0]), float(jv[0]), rtol=2e-2,
                                   atol=1e-2)
        np.testing.assert_allclose(preds[-1], np.asarray(jv[1]),
                                   rtol=2e-2, atol=1e-2)
    assert not np.array_equal(preds[0], preds[1])
    for c, p, v in zip(caps, params, init):
        assert torch.equal(c._t, p._t)
        assert not torch.equal(c._t, v)
