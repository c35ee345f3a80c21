"""The port's ``LBFGS`` on the CPU against the JAX package's.

The reference's two tests (``tests/test_optimizer_distribution_
extras.py``: least squares against ``lstsq`` at atol 1e-3, Rosenbrock
falling below a tenth), each with and without the strong-Wolfe line
search, in both packages on the same data.  Without a line search (the
step is lr times the direction) the solution, the final loss and the
number of closure calls equal JAX's (f32, 1e-4).  With it, the first
iterations too (8 of them: the same decisions from the same host
reads); run to convergence, the search's tests compare losses that
differ below float32's resolution near the optimum (the two packages
sum the dots in other orders), so the path's end is held where the
reference test holds its own: within 1e-3 of ``lstsq`` and of JAX's, and
near Rosenbrock's minimum.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _quadratic(P, line_search, history_size=100, max_iter=30):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    x = P.to_tensor(np.zeros(3, np.float32))
    x.stop_gradient = False
    lr = 1.0 if line_search else 0.05
    opt = P.optimizer.LBFGS(learning_rate=lr, max_iter=max_iter,
                            parameters=[x], line_search_fn=line_search,
                            history_size=history_size)
    At, bt = P.to_tensor(A), P.to_tensor(b)
    calls = []

    def closure():
        opt.clear_grad()
        r = P.matmul(At, x) - bt
        loss = P.sum(r * r)
        loss.backward()
        calls.append(1)
        return loss

    loss = opt.step(closure)
    return (np.asarray(x.numpy()), float(loss.numpy()), len(calls), A, b,
            opt)


@pytest.mark.parametrize("line_search,max_iter", [("strong_wolfe", 8),
                                                  ("strong_wolfe", 30),
                                                  (None, 30)])
def test_lbfgs_quadratic_convergence(line_search, max_iter):
    jx, jloss, jcalls, A, b, _ = _quadratic(jpaddle, line_search,
                                            max_iter=max_iter)
    tx, tloss, tcalls, _, _, opt = _quadratic(tpaddle, line_search,
                                              max_iter=max_iter)
    if line_search and max_iter == 30:
        x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
        np.testing.assert_allclose(tx, x_ref, atol=1e-3)
        np.testing.assert_allclose(tx, jx, atol=1e-3)
        assert tloss < float(np.sum((A @ x_ref - b) ** 2)) + 1e-3
    else:
        np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-5)
        assert tcalls == jcalls
    assert opt.state_dict()["@step"] == 1


def _rosenbrock(P, line_search):
    x = P.to_tensor(np.array([-1.2, 1.0], np.float32))
    x.stop_gradient = False
    opt = P.optimizer.LBFGS(learning_rate=0.5 if line_search else 1e-3,
                            max_iter=50, parameters=[x],
                            line_search_fn=line_search)

    def rosen():
        opt.clear_grad()
        a = x[1] - x[0] * x[0]
        b = 1.0 - x[0]
        loss = 100.0 * a * a + b * b
        loss.backward()
        return loss

    f0 = float(rosen().numpy())
    opt.step(rosen)
    f1 = float(rosen().numpy())
    return f0, f1, np.asarray(x.numpy())


@pytest.mark.parametrize("line_search", ["strong_wolfe", None])
def test_lbfgs_rosenbrock_descends(line_search):
    jf0, jf1, jx = _rosenbrock(jpaddle, line_search)
    tf0, tf1, tx = _rosenbrock(tpaddle, line_search)
    assert tf0 == jf0
    if line_search:
        np.testing.assert_allclose(tx, jx, atol=1e-3)
        np.testing.assert_allclose(tx, [1.0, 1.0], atol=1e-2)
    else:
        np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tf1, jf1, rtol=1e-4, atol=1e-5)
    assert tf1 < tf0 * (0.1 if line_search else 1.0), (tf0, tf1)


def test_lbfgs_history_limit_and_parameters():
    _, _, _, _, _, opt = _quadratic(tpaddle, "strong_wolfe",
                                    history_size=2, max_iter=6)
    assert 1 <= len(opt._s_hist) <= 2 and len(opt._y_hist) == \
        len(opt._s_hist)
    assert opt.max_eval == 6 * 5 // 4
    assert tpaddle.optimizer.LBFGS is \
        tpaddle.incubate.optimizer.LBFGS
    w = tpaddle.create_parameter([3], "float32")
    with pytest.raises(AssertionError, match="closure"):
        tpaddle.optimizer.LBFGS(parameters=[w]).step()
