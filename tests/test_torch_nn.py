"""The port's ``nn`` (``Layer``, the common / activation / norm / loss
layers, initializers, gradient clipping) on the CPU against the JAX
package.

Every ported layer is built the same way in both packages; the port
takes the JAX layer's weights through ``set_state_dict`` of numpy
arrays (so the keys must agree), both run the same seeded input, and
the outputs and the gradients of ``Σ out * w`` w.r.t. the input and
every parameter are compared (f32: outputs 1e-5, gradients 1e-4).
Initializers are held to their laws, the containers, hooks and
train / eval to the reference's behaviour, ``ClipGrad*`` to JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_nn_cases import COMMON, LAYER_NAMES, check_layer


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


@pytest.mark.parametrize("cls,args,kwargs,inputs,eval_,tol", COMMON)
def test_layer_matches_the_reference(cls, args, kwargs, inputs, eval_, tol):
    check_layer(cls, args, kwargs, inputs, eval_, tol)


def test_every_ported_layer_has_a_case():
    import paddle_tpu_torch.nn.layer.activation as act
    import paddle_tpu_torch.nn.layer.common as com
    import paddle_tpu_torch.nn.layer.loss as los
    import paddle_tpu_torch.nn.layer.norm as nrm
    names = set(com.__all__) | set(act.__all__) | set(nrm.__all__) \
        | set(los.__all__)
    names -= {"Linear_"}            # an alias of Linear
    assert names == set(LAYER_NAMES)


def _mlp(paddle):
    nn = paddle.nn
    return nn.Sequential(nn.Linear(3, 4), nn.ReLU(),
                         nn.LayerList([nn.Linear(4, 4), nn.Linear(4, 2)]))


def test_state_dict_keys_and_parameter_order_equal_the_reference():
    j, t = _mlp(jpaddle), _mlp(tpaddle)
    assert list(t.state_dict()) == list(j.state_dict())
    assert [p.shape for p in t.parameters()] == \
        [p.shape for p in j.parameters()]
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    bn_j, bn_t = jpaddle.nn.BatchNorm1D(3), tpaddle.nn.BatchNorm1D(3)
    assert list(bn_t.state_dict()) == list(bn_j.state_dict())
    assert not t.parameters()[0].stop_gradient
    assert t.parameters()[0].is_leaf and t.parameters()[0].persistable


def test_containers_hooks_train_eval():
    nn = tpaddle.nn
    seq = _mlp(tpaddle)
    assert len(seq) == 3 and isinstance(seq[2], nn.LayerList)
    lst = seq[2]
    lst.append(nn.Linear(2, 2))
    lst.insert(0, nn.Identity())
    assert len(lst) == 4 and isinstance(lst[0], nn.Identity)
    assert isinstance(lst[-1], nn.Linear) and len(lst[1:3]) == 2
    d = nn.LayerDict({"a": nn.Linear(2, 2)})
    d["b"] = nn.ReLU()
    assert list(d.keys()) == ["a", "b"] and "b" in d
    del d["b"]
    assert len(d) == 1
    plist = nn.ParameterList([tpaddle.create_parameter([2], "float32")])
    plist.append(tpaddle.create_parameter([3], "float32"))
    assert len(plist.parameters()) == 2

    seq.eval()
    assert not any(l.training for l in seq.sublayers(include_self=True))
    seq.train()
    assert all(l.training for l in seq.sublayers(include_self=True))

    lin = nn.Linear(2, 2)
    calls = []
    h1 = lin.register_forward_pre_hook(
        lambda l, inp: calls.append("pre") or (inp[0] * 2,))
    h2 = lin.register_forward_post_hook(
        lambda l, inp, out: calls.append("post") or out * 0)
    x = tpaddle.ones([1, 2])
    assert float(lin(x).sum()) == 0.0 and calls == ["pre", "post"]
    h1.remove()
    h2.remove()
    np.testing.assert_allclose(lin(x).numpy(),
                               (x.numpy() @ lin.weight.numpy()
                                + lin.bias.numpy()), rtol=1e-6)

    # set_state_dict writes into the parameter's own storage (the same
    # leaf), raw_dict hands out the torch tensors
    w = lin.weight
    lin.set_state_dict({"weight": np.zeros((2, 2), np.float32)})
    assert lin.weight is w and not w.stop_gradient
    assert float(w.abs().sum()) == 0.0
    raw = lin.raw_dict()
    assert torch.is_tensor(raw["weight"]) and raw["weight"] is w._t
    lin.load_raw_dict({"bias": torch.ones(2)})
    assert lin.bias.numpy().tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="shape mismatch"):
        lin.set_state_dict({"weight": np.zeros((3, 2), np.float32)})

    # functional_forward runs forward over substituted tensors, and
    # autograd sees through it
    ws = [torch.ones(2, 2, requires_grad=True), torch.zeros(2)]
    out = lin.functional_forward(ws, torch.ones(1, 2))
    out.sum().backward()
    assert torch.equal(out, torch.full((1, 2), 2.0))
    assert torch.equal(ws[0].grad, torch.ones(2, 2))
    assert lin.weight is w and float(w.abs().sum()) == 0.0

    lin.to(dtype="float64")
    assert lin.weight.dtype == torch.float64 and not lin.weight.stop_gradient


def _draw(paddle, init, shape=(200, 300)):
    paddle.seed(9)
    p = paddle.create_parameter(list(shape), "float32",
                                default_initializer=init)
    return p.numpy()


@pytest.mark.parametrize("name,args,law", [
    ("Constant", (0.5,), lambda x, s: np.all(x == 0.5)),
    ("Normal", (1.0, 2.0),
     lambda x, s: abs(x.mean() - 1) < 0.05 and abs(x.std() - 2) < 0.05),
    ("TruncatedNormal", (0.0, 1.0),
     lambda x, s: np.abs(x).max() <= 2.0 + 1e-6
     and abs(x.std() - 0.8796) < 0.02),
    ("Uniform", (-2.0, 3.0),
     lambda x, s: x.min() >= -2 and x.max() < 3
     and abs(x.mean() - 0.5) < 0.05),
    ("XavierNormal", (),
     lambda x, s: abs(x.std() - np.sqrt(2 / sum(s))) < 0.003),
    ("XavierUniform", (),
     lambda x, s: np.abs(x).max() <= np.sqrt(6 / sum(s))
     and abs(x.std() - np.sqrt(2 / sum(s))) < 0.003),
    ("KaimingNormal", (),
     lambda x, s: abs(x.std() - np.sqrt(2 / s[0])) < 0.005),
    ("KaimingUniform", (),
     lambda x, s: np.abs(x).max() <= np.sqrt(6 / s[0])
     and abs(x.std() - np.sqrt(2 / s[0])) < 0.005),
    ("Orthogonal", (),
     lambda x, s: np.allclose(x.T @ x, np.eye(s[1]), atol=1e-4)
     if s[0] >= s[1] else np.allclose(x @ x.T, np.eye(s[0]), atol=1e-4)),
])
def test_initializer_laws(name, args, law):
    for paddle in (jpaddle, tpaddle):
        init = getattr(paddle.nn.initializer, name)(*args)
        x = _draw(paddle, init)
        assert law(x, x.shape), (paddle.__name__, name)
    # reproducible from the seed, and drawn on the current place
    init = getattr(tpaddle.nn.initializer, name)(*args)
    np.testing.assert_array_equal(_draw(tpaddle, init), _draw(tpaddle, init))


def test_deterministic_initializers_equal_the_reference():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 4)).astype(np.float32)
    for name, args, shape in [("Assign", (v,), (3, 4)),
                              ("Dirac", (), (4, 2, 3, 3)),
                              ("Bilinear", (), (2, 1, 4, 4))]:
        got = _draw(tpaddle, getattr(tpaddle.nn.initializer, name)(*args),
                    shape)
        want = _draw(jpaddle, getattr(jpaddle.nn.initializer, name)(*args),
                     shape)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    assert tpaddle.nn.initializer.calculate_gain("leaky_relu", 0.2) == \
        jpaddle.nn.initializer.calculate_gain("leaky_relu", 0.2)


@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clip_grad_matches_the_reference(clip):
    rng = np.random.default_rng(4)
    ps = [rng.standard_normal(s).astype(np.float32) for s in
          [(3, 4), (5,), (2, 2)]]
    gs = [rng.standard_normal(s).astype(np.float32) * 3 for s in
          [(3, 4), (5,), (2, 2)]]
    outs = []
    for paddle in (jpaddle, tpaddle):
        pairs = [(paddle.to_tensor(p), paddle.to_tensor(g))
                 for p, g in zip(ps, gs)]
        pairs[1][0].need_clip = False
        c = getattr(paddle.nn, clip)(0.7) if clip != "ClipGradByValue" \
            else paddle.nn.ClipGradByValue(0.5, -0.2)
        outs.append([g.numpy() for _, g in c(pairs)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(outs[1][1], gs[1])    # need_clip=False


def test_clip_grad_norm_helpers():
    from paddle_tpu.nn import clip as jclip
    from paddle_tpu_torch.nn import clip as tclip
    rng = np.random.default_rng(6)
    g = rng.standard_normal((4, 3)).astype(np.float32) * 5
    res = []
    for paddle, mod in ((jpaddle, jclip), (tpaddle, tclip)):
        p = paddle.to_tensor(np.zeros((4, 3), np.float32),
                             stop_gradient=False)
        paddle.sum(p * paddle.to_tensor(g)).backward()
        total = mod.clip_grad_norm_([p], 1.0)
        after = p.grad.numpy().copy()
        mod.clip_grad_value_([p], 0.05)
        res.append((float(total.numpy()), after, p.grad.numpy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[0][2], res[1][2], rtol=1e-5, atol=1e-6)
