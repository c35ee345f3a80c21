"""The vision models and ``Model`` on the CPU, held against the JAX
package with the reference's weights crossed over as numpy arrays.

- LeNet: the two packages' synthetic MNIST arrays are bit-equal, and 3
  Adam steps on its first three batches give losses within 1e-5
  relative; the parameters after them within 2e-3 absolute (Adam's
  step, lr 1e-3 a step, turns a rounding difference in a gradient near
  0 into up to 2 lr), and 1e-5 for all but 1 % of the elements.
- ResNet-18 (10 classes, the reference's weights from seed 0) at B 4 x
  3 x 64 x 64 in train mode: logits, loss and the batch norms' running
  statistics within 2e-4 relative and 2e-4 of the array's largest
  magnitude (f32 convolutions summed in another order); every
  parameter's gradient within 5e-3 in relative L2 norm.  The gradients
  are held in norm because a ReLU whose input lies within rounding of 0
  can fall on the other side in one package: at this seed one such
  element moves the stem's and layer1's gradients by up to 1.4e-3 in
  L2 (6e-3 at one element), while every later layer agrees to 1e-5.
- ``Model.fit`` (gradients accumulated over 2 batches, the preemption
  handler armed) / ``evaluate`` / ``predict`` on LeNet: the history's
  loss, the evaluation's loss and accuracy and the predictions against
  the reference's (1e-5 relative, accuracy equal); a SIGTERM during
  ``fit`` saves and exits 101 for a relaunch.
- Every constructor of the zoo builds but the deepest and widest
  variants (a row more of their family's table); the smaller families'
  ``state_dict`` keys and shapes equal the reference's, and each family
  runs a forward at a small input.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _cross(jnet, tnet):
    js = jnet.state_dict()
    assert list(tnet.state_dict()) == list(js)
    assert [tuple(p.shape) for p in tnet.parameters()] == \
        [tuple(p.shape) for p in jnet.parameters()]
    tnet.set_state_dict({k: np.asarray(v.numpy()) for k, v in js.items()})


def _rel_close(a, b, tol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def mnist():
    from paddle_tpu.vision.datasets import MNIST as JM
    from paddle_tpu_torch.vision.datasets import MNIST as TM
    return JM(backend="synthetic"), TM(backend="synthetic")


def _lenets():
    tpaddle.set_device("cpu")
    jpaddle.seed(0)
    j = jpaddle.vision.models.LeNet()
    t = tpaddle.vision.models.LeNet()
    _cross(j, t)
    return j, t


def test_lenet_adam_steps_match_the_reference(mnist):
    jds, tds = mnist
    assert np.array_equal(jds.images, tds.images)
    assert np.array_equal(jds.labels, tds.labels)
    nets = _lenets()
    opts = [P.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
            for P, net in zip((jpaddle, tpaddle), nets)]
    for b in range(3):
        img = jds.images[b * 64:(b + 1) * 64]
        lab = jds.labels[b * 64:(b + 1) * 64]
        losses = []
        for P, net, opt in zip((jpaddle, tpaddle), nets, opts):
            loss = P.nn.CrossEntropyLoss()(
                net(P.to_tensor(img)), P.reshape(P.to_tensor(lab), [-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    js, ts = nets[0].state_dict(), nets[1].state_dict()
    for k in js:
        a, e = ts[k].numpy(), np.asarray(js[k].numpy())
        np.testing.assert_allclose(a, e, atol=2e-3, err_msg=k)
        assert np.mean(np.abs(a - e) > 1e-5) <= 0.01, k


def test_resnet18_train_step_matches_the_reference():
    jpaddle.seed(0)
    jnet = jpaddle.vision.models.resnet18(num_classes=10)
    tnet = tpaddle.vision.models.resnet18(num_classes=10)
    _cross(jnet, tnet)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    outs = []
    for P, net in ((jpaddle, jnet), (tpaddle, tnet)):
        net.train()
        logits = net(P.to_tensor(x))
        loss = P.nn.CrossEntropyLoss()(logits, P.to_tensor(y))
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
        outs.append((logits.numpy(), float(loss.numpy()), grads,
                     {k: v.numpy() for k, v in net.state_dict().items()}))
    (jl, jloss, jg, jst), (tl, tloss, tg, tst) = outs
    _rel_close(tl, jl, 2e-4, "logits")
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4)
    assert list(tg) == list(jg)
    for k in jg:
        err = np.linalg.norm(tg[k] - jg[k]) / np.linalg.norm(jg[k])
        assert err <= 5e-3, (k, err)
    stats = [k for k in jst if k.endswith(("_mean", "_variance"))]
    assert len(stats) == 2 * 20
    for k in stats:
        _rel_close(tst[k], jst[k], 2e-4, k)
        assert not np.allclose(tst[k], 0.0 if k.endswith("_mean") else 1.0)


def test_model_fit_evaluate_predict_match_the_reference(mnist):
    from paddle_tpu.vision.datasets import MNIST as JM
    from paddle_tpu_torch.vision.datasets import MNIST as TM
    nets = _lenets()
    res = []
    for P, net, ds, test in zip((jpaddle, tpaddle), nets, mnist,
                                (JM(mode="test", backend="synthetic"),
                                 TM(mode="test", backend="synthetic"))):
        model = P.Model(net).prepare(
            P.optimizer.Adam(learning_rate=1e-3,
                             parameters=net.parameters()),
            P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        hist = model.fit(ds, batch_size=64, epochs=1, num_iters=4,
                         shuffle=False, verbose=0,
                         accumulate_grad_batches=2, handle_preemption=True)
        ev = model.evaluate(test, batch_size=256, verbose=0)
        pred = model.predict(test, batch_size=256, stack_outputs=True)
        res.append((hist, ev, pred))
    (jh, je, jp), (th, te, tp) = res
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    assert te["acc"] == je["acc"]
    _rel_close(tp[0], jp[0], 1e-5, "predict")


def test_model_fit_saves_and_exits_for_relaunch_on_sigterm(tmp_path):
    import os
    import signal
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Preempt(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
    net = tpaddle.vision.models.LeNet()
    model = tpaddle.Model(net).prepare(
        tpaddle.optimizer.Adam(parameters=net.parameters()),
        tpaddle.nn.CrossEntropyLoss())
    from paddle_tpu_torch.vision.datasets import SyntheticImages
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        model.fit(SyntheticImages(64, (1, 28, 28), 10), batch_size=16,
                  save_dir=str(tmp_path), verbose=0,
                  handle_preemption=True, callbacks=[Preempt()])
    assert exc.value.code == 101
    assert (tmp_path / "preempted.pdparams").exists()
    assert (tmp_path / "preempted.pdopt").exists()
    # the handler is uninstalled: SIGTERM's disposition is as before
    assert signal.getsignal(signal.SIGTERM) == before


def test_model_summary_save_load(tmp_path):
    net = tpaddle.vision.models.LeNet()
    model = tpaddle.Model(net).prepare(
        tpaddle.optimizer.Adam(parameters=net.parameters()),
        tpaddle.nn.CrossEntropyLoss())
    jnet = jpaddle.vision.models.LeNet()
    assert model.summary() == jpaddle.summary(jnet)
    x = np.random.default_rng(1).standard_normal((2, 1, 28, 28)).astype(
        np.float32)
    model.train_batch([x], [np.array([[1], [2]])])
    model.save(str(tmp_path / "m"))
    other = tpaddle.Model(tpaddle.vision.models.LeNet()).prepare(
        tpaddle.optimizer.Adam(parameters=net.parameters()))
    other.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(other.predict_batch([x])[0],
                                  model.predict_batch([x])[0])


# the smaller families: keys and shapes against the reference's
_SAME_KEYS = ["mobilenet_v1", "shufflenet_v2_x0_25"]


@pytest.mark.parametrize("name", _SAME_KEYS)
def test_zoo_state_dict_equals_the_reference(name):
    j = getattr(jpaddle.vision.models, name)(num_classes=10)
    t = getattr(tpaddle.vision.models, name)(num_classes=10)
    js, ts = j.state_dict(), t.state_dict()
    assert list(ts) == list(js)
    assert [tuple(ts[k].shape) for k in ts] == \
        [tuple(js[k].shape) for k in js]


# one forward a family, at a small input, in eval mode
_FORWARD = [("resnext50_32x4d", 32), ("wide_resnet50_2", 32),
            ("vgg11", 32), ("alexnet", 64), ("squeezenet1_0", 48),
            ("googlenet", 64), ("inception_v3", 80), ("densenet121", 32),
            ("mobilenet_v2", 32), ("mobilenet_v3_small", 32),
            ("mobilenet_v3_large", 32), ("shufflenet_v2_swish", 32)]


@pytest.mark.parametrize("name,size", _FORWARD, ids=[n for n, _ in _FORWARD])
def test_zoo_forward(name, size):
    net = getattr(tpaddle.vision.models, name)(num_classes=7)
    net.eval()
    x = tpaddle.to_tensor(np.random.default_rng(2).standard_normal(
        (1, 3, size, size)).astype(np.float32))
    with tpaddle.no_grad():
        out = net(x)
    out = out[0] if isinstance(out, (list, tuple)) else out
    assert out.shape == [1, 7] and np.isfinite(out.numpy()).all()


def test_every_constructor_builds_and_pretrained_needs_an_artifact(
        tmp_path, monkeypatch):
    import paddle_tpu_torch.vision.models as M
    monkeypatch.setenv("PADDLE_TPU_PRETRAINED_HOME", str(tmp_path))
    ctors = [n for n in M.__all__ if n[0].islower()]
    assert len(ctors) == 38
    # the deepest and widest variants differ from a built one only in a
    # row of their family's table; building them costs seconds each
    big = {"resnet101", "resnet152", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "wide_resnet101_2",
           "vgg13", "vgg16", "vgg19"}
    for name in ctors:
        assert callable(getattr(M, name)), name
        if name not in big:
            net = getattr(M, name)(num_classes=10)
            assert net.parameters() and net.state_dict()
            del net
    for name in ("resnet18", "mobilenet_v3_small"):
        with pytest.raises(RuntimeError, match="no weights artifact"):
            getattr(M, name)(pretrained=True, num_classes=3)
    # a local artifact hydrates the net, in the reference's layout
    src = M.squeezenet1_1(num_classes=3)
    np.savez(tmp_path / "squeezenet1_1.npz",
             **{k: v.numpy() for k, v in src.state_dict().items()})
    got = M.squeezenet1_1(pretrained=True, num_classes=3)
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(got.state_dict()[k].numpy(), v.numpy())
    with pytest.raises(RuntimeError, match="nothing is downloaded"):
        M.squeezenet1_1(pretrained="https://example.invalid/w.pdparams")
