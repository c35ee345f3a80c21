"""The eager core's facade and autograd (``paddle_tpu_torch/core``,
``autograd/``) on the CPU, held against the JAX package.

``tests/test_autograd.py``'s cases run on both packages: each test takes
a package as ``paddle`` and checks the same expected values, and the
gradients of the matmul / broadcast / softmax / layer-norm / attention
cases are compared between the two (f32, 1e-4).  Beyond them: the
reference's ``to_tensor`` dtype rules (a dtype compared through the
mapping int64 <-> int32, since JAX runs with x64 off), no place meaning
the card or an error, bf16 ``numpy()``, operator promotion, ``__setitem__``
under autograd, and ``save`` / ``load`` of Tensors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

PKGS = {"jax": jpaddle, "torch": tpaddle}


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


@pytest.fixture(params=sorted(PKGS))
def paddle(request):
    return PKGS[request.param]


def _both(fn):
    """fn(paddle) on both packages; the numpy results side by side."""
    return fn(jpaddle), fn(tpaddle)


def _close(a, b, tol=1e-4):
    if isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _close(x, y, tol)
        return
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# -- test_autograd.py's cases on both packages --------------------------------

def test_simple_chain(paddle):
    x = paddle.to_tensor([2.0, 3.0], stop_gradient=False)
    paddle.sum(x * x * x).backward()
    np.testing.assert_allclose(x.grad.numpy(), 3 * np.array([4.0, 9.0]),
                               rtol=1e-5)


def _grads(op, *arrays):
    def fn(paddle):
        ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
        paddle.sum(op(paddle)(*ts) * 1.5).backward()
        return [t.grad.numpy() for t in ts]
    return fn


@pytest.mark.parametrize("op", ["matmul", "add", "multiply"])
def test_matmul_and_broadcast_grads_agree(op):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype("float32")
    b = rng.standard_normal((4, 5) if op == "matmul" else (4,)).astype(
        "float32")
    j, t = _both(_grads(lambda p: getattr(p, op), a, b))
    _close(j, t)
    assert t[1].shape == b.shape


def test_accumulation(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])


def test_stop_gradient(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.to_tensor([2.0], stop_gradient=True)
    paddle.sum(x * y).backward()
    assert x.grad is not None
    assert y.grad is None


def test_detach(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = x * 2
    d = y.detach()
    assert d.stop_gradient
    paddle.sum(y * 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0])


def test_retain_graph(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.sum(x * x)
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0])


def test_double_backward_raises(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.sum(x * x)
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_backward_rules(paddle):
    x = paddle.to_tensor([1.0, 2.0])
    with pytest.raises(RuntimeError, match="stop_gradient"):
        x.backward()
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="non-scalar"):
        (x * 2).backward()
    y = x * 2
    y.backward(paddle.to_tensor([1.0, 3.0]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 6.0])
    # only leaves receive .grad
    assert y.grad is None


def test_hook(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(g.numpy().copy())
        return g * 2

    remove = x.register_hook(hook)
    paddle.sum(x * 3).backward()
    assert len(seen) == 1
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])
    remove()
    x.clear_grad()
    paddle.sum(x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


def test_multi_output_op(paddle):
    x = paddle.to_tensor(np.random.default_rng(1).standard_normal(
        (4, 6)).astype("float32"), stop_gradient=False)
    a, b = paddle.split(x, 2, axis=1)
    (paddle.sum(a * 2) + paddle.sum(b * 3)).backward()
    ref = np.concatenate([np.full((4, 3), 2.0), np.full((4, 3), 3.0)], 1)
    np.testing.assert_allclose(x.grad.numpy(), ref)


def test_paddle_grad(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (gx,) = paddle.autograd.grad(x * x, x, create_graph=False)
    np.testing.assert_allclose(gx.numpy(), [4.0])
    assert x.grad is None  # paddle.grad must not pollute .grad
    z = paddle.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="unused"):
        paddle.autograd.grad(paddle.sum(x * x), [x, z])
    gx, gz = paddle.autograd.grad(paddle.sum(x * x), [x, z],
                                  allow_unused=True)
    assert gz is None


def test_grad_create_graph(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (gx,) = paddle.autograd.grad(paddle.sum(x * x * x), x, create_graph=True)
    paddle.sum(gx).backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0], rtol=1e-5)


def test_vjp_jvp(paddle):
    from_ = paddle.autograd

    def f(x):
        return paddle.sum(x * x)
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    out, g = from_.vjp(f, x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    np.testing.assert_allclose(out.numpy(), 5.0)
    out, tangent = from_.jvp(f, x)
    np.testing.assert_allclose(tangent.item(), 6.0)


def test_jacobian_hessian(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    j = paddle.autograd.jacobian(lambda v: v * v, x)
    np.testing.assert_allclose(j.numpy(), np.diag([2.0, 4.0]))
    h = paddle.autograd.hessian(lambda v: paddle.sum(v * v * v), x)
    np.testing.assert_allclose(h.numpy(), np.diag([6.0, 12.0]))


def test_pylayer(paddle):
    PyLayer = paddle.autograd.PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor()
            return gy * 3 * x * x * ctx.k

    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = Cube.apply(x, 2.0)
    assert not y.stop_gradient
    paddle.sum(y).backward()
    np.testing.assert_allclose(x.grad.numpy(), [24.0])

    class L(PyLayer):
        pass
    with pytest.raises(RuntimeError):
        L()


def test_pylayer_saved_tensors_hooks(paddle):
    seen = []

    class Square(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor()
            return gy * 2 * x

    def pack(t):
        seen.append("pack")
        return t * 1.0

    def unpack(t):
        seen.append("unpack")
        return t

    x = paddle.to_tensor([3.0], stop_gradient=False)
    with paddle.autograd.saved_tensors_hooks(pack, unpack):
        y = Square.apply(x)
    paddle.sum(y).backward()
    assert seen == ["pack", "unpack"]
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_no_grad_context_and_decorator(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        assert (x * 2).stop_gradient

    @paddle.no_grad()
    def f(v):
        return v * 2
    assert f(x).stop_gradient
    assert not (x * 2).stop_gradient
    with paddle.no_grad():
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient


def test_inplace_backward(paddle):
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    y = x * 2
    y.reshape_([4])
    paddle.sum(y * 1.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((2, 2), 2.0))

    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 3
    paddle.increment(y, 1.0)
    paddle.sum(y * 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])
    np.testing.assert_allclose(y.numpy(), [4.0])

    x = paddle.to_tensor([-1.0, 2.0], stop_gradient=False)
    y = x * 1.0
    paddle.nn.functional.relu_(y)
    paddle.sum(y).backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 1.0])


def test_inplace_keeps_the_old_value_in_the_graph():
    """y * y read y before add_: its gradient still reaches x.  (The
    JAX package's tape drops it: the in-place op's node runs before the
    earlier consumer's, ROADMAP C.)"""
    paddle = tpaddle
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * 1.0
    z = y * y
    y.add_(paddle.to_tensor([5.0]))
    y.scale_(2.0)
    paddle.sum(z + y).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2 * 2.0 + 2.0])
    np.testing.assert_allclose(y.numpy(), [14.0])


def test_setitem_under_autograd(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    v = paddle.to_tensor([10.0], stop_gradient=False)
    y = x * 1.0
    y[1:2] = v
    paddle.sum(y * paddle.to_tensor([1.0, 2.0, 3.0])).backward()
    np.testing.assert_allclose(y.numpy(), [1.0, 10.0, 3.0])
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 0.0, 3.0])
    np.testing.assert_allclose(v.grad.numpy(), [2.0])
    c = paddle.to_tensor([1.0, 2.0])
    c[0] = 5.0
    np.testing.assert_allclose(c.numpy(), [5.0, 2.0])


def test_tensor_methods_installed(paddle):
    t = paddle.to_tensor([[1.0, 2.0]])
    assert t.sum().item() == 3.0
    assert t.mean().item() == 1.5
    assert t.abs().shape == [1, 2]
    assert t.exp().shape == [1, 2]
    assert t.reshape([2, 1]).shape == [2, 1]
    assert t.sum(axis=1).shape == [1]
    assert isinstance(t.shape, list)
    assert t.astype("int32").numpy().dtype.kind == "i"
    assert (t > 1.5).numpy().tolist() == [[False, True]]
    assert t.T.shape == [2, 1]
    assert len(t) == 1 and t.ndim == 2 and t.size == 2
    with pytest.raises(Exception):
        paddle.split(paddle.arange(7), 3)
    u = paddle.tensor.unfold(paddle.randn([10, 4]), 0, 3, 1)
    assert u.shape == [8, 4, 3]


@pytest.mark.parametrize("name", ["softmax", "layer_norm", "attention"])
def test_functional_grads_agree(name):
    rng = np.random.default_rng(2)
    if name == "softmax":
        arrays = [rng.standard_normal((3, 5)).astype("float32")]
        op = lambda p: p.nn.functional.softmax  # noqa: E731
    elif name == "layer_norm":
        arrays = [rng.standard_normal((2, 6)).astype("float32"),
                  rng.uniform(0.5, 1.5, 6).astype("float32"),
                  rng.standard_normal(6).astype("float32")]
        op = lambda p: lambda x, w, b: p.nn.functional.layer_norm(  # noqa
            x, 6, w, b)
    else:
        arrays = [rng.standard_normal((2, 4, 2, 8)).astype("float32")
                  for _ in range(3)]
        op = lambda p: lambda q, k, v: (  # noqa: E731
            p.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    j, t = _both(_grads(op, *arrays))
    _close(j, t)


# -- the facade's own rules -------------------------------------------------------

_KIND = {"int64": "int", "int32": "int", "float32": "float32",
         "bool": "bool", "float16": "float16", "float64": "float64"}


def _dtype_name(paddle, t):
    return str(t.dtype).replace("torch.", "") if paddle is tpaddle \
        else np.dtype(t.dtype).name


@pytest.mark.parametrize("data,dtype,want", [
    (1, None, "int"), (1.5, None, "float32"), (True, None, "bool"),
    ([1, 2], None, "int"), ([1.0, 2.0], None, "float32"),
    (np.arange(3, dtype=np.float64), None, "float32"),
    (np.arange(3, dtype=np.int32), None, "int"),
    (np.arange(3, dtype=np.float16), None, "float16"),
    ([1, 2], "float32", "float32"),
])
def test_to_tensor_dtype_rules(data, dtype, want):
    for paddle in (jpaddle, tpaddle):
        t = paddle.to_tensor(data, dtype=dtype)
        assert _KIND[_dtype_name(paddle, t)] == want, (paddle.__name__, t)
    # the port keeps what the code asks for: int64, float64 when named
    assert tpaddle.to_tensor(1).dtype == torch.int64
    assert tpaddle.to_tensor(np.arange(3)).dtype == torch.int64
    assert tpaddle.to_tensor([1.0], dtype="float64").dtype == torch.float64


def test_to_tensor_copies_and_keeps_stop_gradient():
    a = np.ones(3, np.float32)
    t = tpaddle.to_tensor(a)
    a[0] = 5.0
    assert t.numpy()[0] == 1.0 and t.stop_gradient
    u = tpaddle.to_tensor(t, stop_gradient=False)
    assert not u.stop_gradient and u.is_leaf
    assert u._t.data_ptr() != t._t.data_ptr()


def test_no_place_means_the_card_or_an_error(monkeypatch):
    from paddle_tpu_torch.core import place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(place, "_CURRENT", [None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaddle.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaddle.get_device()
    tpaddle.set_device("cpu")
    assert tpaddle.get_device() == "cpu"
    assert tpaddle.ones([2]).place == tpaddle.CPUPlace()
    assert tpaddle.CUDAPlace(1).device == torch.device("cuda", 1)
    assert tpaddle.set_device("gpu:1") == tpaddle.CUDAPlace(1)


def test_bf16_numpy_is_float32_exactly():
    t = tpaddle.to_tensor([1.0, 2.5, 3.015625], dtype="bfloat16")
    a = t.numpy()
    assert a.dtype == np.float32
    assert a.tolist() == [1.0, 2.5, 3.015625]


def test_binary_ops_promote_as_jax_does():
    for paddle in (jpaddle, tpaddle):
        x = paddle.to_tensor([1.0, 2.0], dtype="bfloat16")
        assert "float32" in str((x * 2.0).dtype)
        i = paddle.to_tensor([1, 2], dtype="int32")
        assert "float32" in str((i + 0.5).dtype)
        assert "bool" in str((i > 1).dtype)


def test_check_nan_inf_flag():
    x = tpaddle.to_tensor([1.0, 0.0])
    tpaddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            tpaddle.log(x - 1.0)
        tpaddle.exp(x)
    finally:
        tpaddle.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(tpaddle.log(x - 1.0).numpy()).any()


def test_seed_and_rng_state():
    tpaddle.seed(7)
    a = tpaddle.rand([5]).numpy()
    tpaddle.seed(7)
    np.testing.assert_array_equal(tpaddle.rand([5]).numpy(), a)
    st = tpaddle.get_rng_state()
    b = tpaddle.randn([5]).numpy()
    tpaddle.set_rng_state(st)
    np.testing.assert_array_equal(tpaddle.randn([5]).numpy(), b)


def test_save_load_tensors_and_a_layer(tmp_path):
    net = tpaddle.nn.Linear(3, 2)
    path = str(tmp_path / "m.pdparams")
    tpaddle.save(net.state_dict(), path)
    sd = tpaddle.load(path)
    assert all(isinstance(v, tpaddle.Tensor) for v in sd.values())
    other = tpaddle.nn.Linear(3, 2)
    other.set_state_dict(sd)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(),
                                      v.numpy())
    # the framework reader keeps torch tensors (the checkpoint code's)
    from paddle_tpu_torch.framework import io as fio
    assert all(torch.is_tensor(v) for v in fio.load(path).values())
    bf = tpaddle.to_tensor([1.5], dtype="bfloat16")
    tpaddle.save({"x": bf}, path)
    assert tpaddle.load(path)["x"].dtype == torch.bfloat16


# -- cutting the graph at a tensor marked after the fact (ROADMAP C1) --------

def _cut_repro(paddle):
    a = paddle.to_tensor(np.array([1.0, 2.0], np.float32),
                         stop_gradient=False)
    x = a * 2
    return a, x, paddle.sum(x * 3)


def test_grad_cuts_at_no_grad_vars(paddle):
    """An input reached only through ``no_grad_vars`` has no gradient:
    None with ``allow_unused``, the "appears unused" error without."""
    a, x, y = _cut_repro(paddle)
    assert paddle.grad([y], [a], no_grad_vars=[x],
                       allow_unused=True) == [None]
    a, x, y = _cut_repro(paddle)
    with pytest.raises(RuntimeError, match="appears unused"):
        paddle.grad([y], [a], no_grad_vars=[x])
    # the cut is for the call only: the same graph differentiates again
    a, x, y = _cut_repro(paddle)
    paddle.grad([y], [a], no_grad_vars=[x], allow_unused=True,
                retain_graph=True)
    np.testing.assert_allclose(paddle.grad([y], [a])[0].numpy(), [6, 6])


def test_grad_no_grad_vars_keeps_the_other_paths():
    def fn(paddle):
        a = paddle.to_tensor(np.array([1.0, 2.0], np.float32),
                             stop_gradient=False)
        b = paddle.to_tensor(np.array([3.0, -1.0], np.float32),
                             stop_gradient=False)
        x = a * b
        y = paddle.sum(x * 3 + a * a + paddle.exp(b))
        return [g.numpy() for g in paddle.grad([y], [a, b],
                                               no_grad_vars=[x])]
    want, got = _both(fn)
    _close(got, want)
    np.testing.assert_allclose(got[0], [2.0, 4.0])


def test_stop_gradient_set_after_use_cuts_backward(paddle):
    """``stop_gradient = True`` on a consumed non-leaf cuts there: a
    leaf reached only through it keeps ``grad`` None, not zeros."""
    a, x, y = _cut_repro(paddle)
    x.stop_gradient = True
    y.backward()
    assert a.grad is None
    a = paddle.to_tensor(np.array([1.0, 2.0], np.float32),
                         stop_gradient=False)
    b = paddle.to_tensor(np.array([0.5, 4.0], np.float32),
                         stop_gradient=False)
    x = a * 2
    y = paddle.sum(x * 3 + b * a)
    x.stop_gradient = True
    y.backward()
    np.testing.assert_allclose(a.grad.numpy(), [0.5, 4.0])
    np.testing.assert_allclose(b.grad.numpy(), [1.0, 2.0])


def test_cuts_cost_nothing_once_their_graph_is_gone():
    from paddle_tpu_torch.core import tensor as core
    import gc
    a, x, y = _cut_repro(tpaddle)
    x.stop_gradient = True
    assert core._LIVE_CUTS[0] >= 1
    del a, x, y
    gc.collect()
    assert core._LIVE_CUTS[0] == 0
    a, x, y = _cut_repro(tpaddle)
    tpaddle.grad([y], [a], no_grad_vars=[x], allow_unused=True)
    del a, x, y
    gc.collect()
    assert core._LIVE_CUTS[0] == 0
