"""dy2static in the port against the reference: Python if / while / for on
tensor predicates under ``to_static`` (``paddle_tpu_torch/jit/dy2static.py``
and ``static/control_flow.py``; reference ``paddle_tpu/jit/dy2static.py``,
its tests ``tests/test_dy2static.py``).

Every case of the reference's file runs here through both packages: the
same function source, converted by each package's pass, on the same
numpy inputs; outputs are compared with each other (rtol 1e-6) and with
the reference test's expected values, and each refusal is held to the
reference's.  The module global ``P`` is the package under test while a
case runs: the converted functions read it at call time.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch.jit import dy2static as td2s

P = None          # the package under test while a case runs
D2S = None        # its dy2static module


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.jit.enable_to_static(True)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else x


def both(case, rtol=1e-6):
    """Run ``case()`` with P set to each package; compare the results
    (numpy) and return the reference's."""
    global P, D2S
    got = {}
    for name, pkg, d2s in (("jax", jp, jd2s), ("torch", tp, td2s)):
        P, D2S = pkg, d2s
        got[name] = case()
    P = D2S = None
    for a, b in zip(_flat(got["jax"]), _flat(got["torch"])):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64), rtol=rtol,
                                       atol=1e-7)
        else:
            assert a == b
    return got["jax"]


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _flat(e)]
    return [v]


def t(v, dtype=np.float32):
    return P.to_tensor(np.array(v, dtype))


def test_if_both_branches_traced():
    def case():
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = -x
            return y + 1.0
        return [_np(f(t([1.0, 2.0]))), _np(f(t([-1.0, -2.0])))]
    pos, neg = both(case)
    np.testing.assert_allclose(pos, [3.0, 5.0])
    np.testing.assert_allclose(neg, [2.0, 3.0])


def test_if_elif_chain():
    def case():
        @P.jit.to_static
        def f(x):
            if x.sum() > 10.0:
                y = x * 0.0
            elif x.sum() > 0:
                y = x * 2.0
            else:
                y = -x
            return y
        return [_np(f(t([v]))) for v in (20.0, 1.0, -3.0)]
    assert [float(v[0]) for v in both(case)] == [0.0, 2.0, 3.0]


def test_while_on_tensor_predicate():
    def case():
        @P.jit.to_static
        def f(n):
            i = P.to_tensor(0)
            s = P.to_tensor(1.0)
            while i < n:
                s = s * 2.0
                i = i + 1
            return s
        return [float(_np(f(P.to_tensor(5)))), float(_np(f(P.to_tensor(0))))]
    assert both(case) == [32.0, 1.0]


def test_python_predicates_keep_python_semantics():
    def case():
        @P.jit.to_static
        def f(x, flag):
            if flag:  # concrete python bool: plain dispatch
                y = x + 1.0
            else:
                y = x - 1.0
            i = 0
            while i < 3:  # concrete python loop
                y = y * 2.0
                i = i + 1
            return y
        return _np(f(t([1.0]), True))
    np.testing.assert_allclose(both(case), [16.0])


def _raw_mixed(x):
    acc = x * 1.0
    if x.sum() > 0:
        acc = acc + 10.0
    k = P.to_tensor(0)
    while k < 2:
        acc = acc * 2.0
        k = k + 1
    return acc


def test_mixed_eager_matches_converted():
    def case():
        conv = D2S.convert_to_static(_raw_mixed)
        assert conv is not _raw_mixed
        x = t([0.5])
        return [_np(conv(x)), _np(_raw_mixed(x))]
    a, b = both(case)
    np.testing.assert_allclose(a, b)


def test_one_sided_assignment_raises_clearly():
    def case():
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                extra = x * 3.0
            return extra  # only defined on one branch
        with pytest.raises(Exception):
            f(t([1.0]))
        return True
    both(case)


def test_port_one_sided_message_is_the_references():
    """The traced refusal carries the reference's message."""
    global P
    P = tp

    @tp.jit.to_static
    def f(x):
        if x.sum() > 0:
            extra = x * 3.0
        return extra
    with pytest.raises(Exception, match="assigned in only one branch"):
        f(t([1.0]))
    P = None


def _no_control_flow(x):
    return x * 2


def test_unconvertible_source_falls_back():
    def case():
        fn = lambda x: x + 1  # noqa: E731 -- lambdas aren't converted
        assert D2S.convert_to_static(fn) is fn
        assert D2S.convert_to_static(_no_control_flow) is _no_control_flow
        return True
    both(case)


def test_nested_function_scope_not_mangled():
    def case():
        @P.jit.to_static
        def f(x):
            def inner(v):
                return v + 1.0
            if x.sum() > 0:
                y = inner(x)
            else:
                y = inner(-x)
            return y
        return _np(f(t([2.0])))
    np.testing.assert_allclose(both(case), [3.0])


_COUNTER = 0


def test_global_writes_survive_conversion():
    def case():
        @P.jit.to_static
        def f(x):
            global _COUNTER
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = -x
            _COUNTER = _COUNTER + 1
            return y
        before = _COUNTER
        f(t([1.0]))
        return _COUNTER >= before + 1  # landed in the real module globals
    assert both(case) is True


def test_layer_forward_with_control_flow():
    nets = {}

    def case():
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = P.nn.Linear(4, 4)

            def forward(self, x):
                if P.mean(x) > 0:
                    y = self.fc(x)
                else:
                    y = self.fc(-x) * 0.5
                return y

        net = Net()
        if P is tp:      # the reference's weights, through numpy
            net.set_state_dict({k: v.numpy() for k, v in
                                nets["jax"].state_dict().items()})
        else:
            nets["jax"] = net
        net = P.jit.to_static(net)
        pos = P.to_tensor(np.ones((2, 4), np.float32))
        neg = P.to_tensor(-np.ones((2, 4), np.float32))
        return [_np(net.forward(neg)), _np(net.forward(pos))]
    neg, pos = both(case)
    np.testing.assert_allclose(neg, 0.5 * pos, rtol=1e-5, atol=1e-6)


def test_foreign_decorator_disables_conversion():
    def case():
        def mydeco(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                return fn(*a, **k)
            return inner

        @mydeco
        def f(x):
            if x.sum() > 0:
                y = x
            else:
                y = -x
            return y

        # source shows @mydeco: rewriting would drop it -- must fall back
        assert D2S.convert_to_static(f) is f
        return True
    both(case)


def _one_sided(x, flag):
    if flag:
        y = x + 1.0
    return y


def test_one_sided_concrete_restores_unbound_semantics():
    def case():
        conv = D2S.convert_to_static(_one_sided)
        assert conv is not _one_sided
        x = t([1.0])
        out = _np(conv(x, True))
        with pytest.raises(UnboundLocalError):
            conv(x, False)
        return out
    np.testing.assert_allclose(both(case), [2.0])


def test_closure_function_falls_back():
    def case():
        s = 2.0

        def f(x):
            if x.sum() > 0:
                y = x * s
            else:
                y = -x
            return y

        assert D2S.convert_to_static(f) is f  # closures keep plain tracing
        return True
    both(case)


_LR = 0.1


def _global_in_branch(x, warm):
    global _LR
    if warm:
        _LR = 0.01
        y = x * 1.0
    else:
        y = x * 2.0
    if x.sum() > 100.0:   # a convertible if keeps conversion active
        z = x * 0.0
    else:
        z = y
    return z


def test_global_assigned_in_branch_not_corrupted():
    def case():
        global _LR
        conv = D2S.convert_to_static(_global_in_branch)
        assert conv is not _global_in_branch  # the second if converted...
        x = t([1.0])
        a = _np(conv(x, False))
        assert _LR == 0.1  # ...but the global-assigning one was left alone
        b = _np(conv(x, True))
        assert _LR == 0.01  # python `if` semantics kept for the global
        _LR = 0.1
        return [a, b]
    a, b = both(case)
    np.testing.assert_allclose(a, [2.0])
    np.testing.assert_allclose(b, [1.0])


def _elif_dead(x, p1, p2):
    if p1:
        y = 1.0
    elif p2:
        y = 2.0
    return x


def test_elif_chain_no_branch_taken():
    def case():
        conv = D2S.convert_to_static(_elif_dead)
        x = t([5.0])
        return [_np(conv(x, False, False)), _np(conv(x, True, False))]
    for v in both(case):
        np.testing.assert_allclose(v, [5.0])


def test_for_range_converts_to_while():
    def case():
        @P.jit.to_static
        def cumsum_to(n):
            total = P.to_tensor(np.float32(0))
            for i in range(n):
                total = total + i
            return total
        return float(_np(cumsum_to(5)))
    assert both(case) == 10.0


def test_for_range_negative_step_and_nested_if():
    def case():
        @P.jit.to_static
        def countdown(n):
            s = P.to_tensor(np.float32(0))
            for i in range(n, 0, -2):
                s = s + i
            return s

        @P.jit.to_static
        def nested(n):
            acc = P.to_tensor(np.float32(0))
            for i in range(n):
                if i % 2 == 0:
                    acc = acc + 1.0
                else:
                    acc = acc + 0.5
            return acc
        return [float(_np(countdown(6))), float(_np(nested(4)))]
    assert both(case) == [12.0, 3.0]


def _plain_sum(xs):
    acc = P.to_tensor(np.float32(0))
    for x in xs:
        acc = acc + x
    return acc


def test_for_non_range_iterable_unrolls():
    def case():
        return float(_np(P.jit.to_static(_plain_sum)([1.0, 2.0, 3.0])))
    assert both(case) == 6.0


def test_break_in_while_converts():
    def case():
        @P.jit.to_static
        def sum_until(n, limit):
            s = P.to_tensor(np.float32(0))
            i = 0
            while i < n:
                s = s + i
                if s > limit:
                    break
                i = i + 1
            return s
        return [float(_np(sum_until(n, lim)))
                for n, lim in [(10, 6.0), (10, 1000.0), (3, 0.5)]]

    def ref(n, limit):
        s, i = 0.0, 0
        while i < n:
            s += i
            if s > limit:
                break
            i += 1
        return s
    assert both(case) == [ref(n, lim) for n, lim in
                          [(10, 6.0), (10, 1000.0), (3, 0.5)]]


def test_continue_and_break_in_for():
    def case():
        @P.jit.to_static
        def skip_evens(n):
            s = P.to_tensor(np.float32(0))
            for i in range(n):
                if i % 2 == 0:
                    continue
                s = s + i
            return s

        @P.jit.to_static
        def mixed(n):
            s = P.to_tensor(np.float32(0))
            for i in range(n):
                if i == 1:
                    continue
                if i >= 4:
                    break
                s = s + i
            return s
        return [float(_np(skip_evens(6))), float(_np(mixed(10)))]
    assert both(case) == [9.0, 5.0]


def test_loop_var_preserved_after_break():
    def case():
        @P.jit.to_static
        def var_after_break(n):
            s = P.to_tensor(np.float32(0))
            i = 0
            for i in range(n):
                if i >= 3:
                    break
                s = s + 1
            return s + i
        return float(_np(var_after_break(10)))
    assert both(case) == 6.0  # i stays 3


def test_tensor_predicated_break_with_concrete_bounds():
    def case():
        @P.jit.to_static
        def tensor_break(limit):
            s = P.to_tensor(np.float32(0))
            for i in range(5):
                s = s + 1.0
                if s > limit:
                    break
            return s
        return [float(_np(tensor_break(P.to_tensor(np.float32(v)))))
                for v in (3.0, 100.0)]
    assert both(case) == [4.0, 5.0]


def test_nested_range_loops_convert():
    def case():
        @P.jit.to_static
        def nested_loops(n):
            s = P.to_tensor(np.float32(0))
            for i in range(n):
                for j in range(n):
                    s = s + 1
            return s

        @P.jit.to_static
        def nested_break(n):
            s = P.to_tensor(np.float32(0))
            for i in range(n):
                for j in range(n):
                    if j >= 2:
                        break
                    s = s + 1
            return s
        return [float(_np(nested_loops(4))), float(_np(nested_break(5)))]
    assert both(case) == [16.0, 10.0]


def _with_try(n):
    s = P.to_tensor(np.float32(0))
    while n > 0:
        try:
            s = s + 1
        finally:
            pass
        return s
    return s


def test_unconvertible_function_keeps_original_object():
    def case():
        assert D2S.convert_to_static(_with_try) is _with_try
        return True
    both(case)


def test_early_return_tensor_predicate():
    def case():
        @P.jit.to_static
        def f(x):
            if x.sum() > 0:
                return x * 2.0
            return -x
        return [_np(f(t([1.0, 2.0]))), _np(f(t([-1.0, -2.0])))]
    pos, neg = both(case)
    np.testing.assert_allclose(pos, [2.0, 4.0])
    np.testing.assert_allclose(neg, [1.0, 2.0])


def test_early_return_with_trailing_compute():
    def case():
        @P.jit.to_static
        def f(x):
            if x.sum() > 10.0:
                return x * 0.0
            y = x + 1.0
            if y.sum() > 0:
                return y * y
            return y - 1.0
        return [_np(f(t([v]))) for v in (20.0, 2.0, -5.0)]
    assert [float(v[0]) for v in both(case)] == [0.0, 9.0, -5.0]


def _early(x):
    if x.max() > 1.0:
        return x / x.max()
    s = x + 0.5
    if s.min() < 0:
        return s * 0.0
    return s


def test_early_return_matches_eager():
    def case():
        converted = D2S.convert_to_static(_early)
        assert converted is not _early
        out = []
        for v in ([3.0, 1.0], [0.2, 0.1], [-2.0, 0.3]):
            x = t(v)
            got, want = _np(converted(x)), _np(_early(x))
            np.testing.assert_allclose(got, want, rtol=1e-6)
            out.append(got)
        return out
    both(case)


def _early_none(flag, x):
    if flag:
        return x * 2.0
    # falls off the end -> None


def test_early_return_none_fallthrough_concrete():
    def case():
        converted = D2S.convert_to_static(_early_none)
        x = t([1.0])
        assert converted(False, x) is None
        return _np(converted(True, x))
    np.testing.assert_allclose(both(case), [2.0])


def test_for_over_tensor_rows():
    m_np = np.arange(12, dtype=np.float32).reshape(4, 3)

    def case():
        @P.jit.to_static
        def f(m):
            acc = P.zeros([3])
            for row in m:
                acc = acc + row * row
            return acc
        return _np(f(P.to_tensor(m_np)))
    np.testing.assert_allclose(both(case), (m_np ** 2).sum(axis=0),
                               rtol=1e-6)


def test_for_enumerate_and_zip():
    m_np = np.arange(12, dtype=np.float32).reshape(4, 3)
    scales = [0.5, 1.0, 1.5, 2.0]

    def case():
        @P.jit.to_static
        def f(m, scales):
            acc = P.zeros([3])
            for i, row in enumerate(m):
                acc = acc + row * float(i)
            for row, s in zip(m, scales):
                acc = acc + row * s
            return acc
        return _np(f(P.to_tensor(m_np), scales))
    want = sum(m_np[i] * i for i in range(4)) + \
        sum(m_np[i] * scales[i] for i in range(4))
    np.testing.assert_allclose(both(case), want, rtol=1e-6)


def test_list_append_in_concrete_loop():
    def case():
        @P.jit.to_static
        def f(x):
            outs = []
            for i in range(3):  # concrete bound: the loop unrolls
                outs.append(x * float(i + 1))
            return P.stack(outs).sum(axis=0)
        return _np(f(t([1.0, 2.0])))
    np.testing.assert_allclose(both(case), [6.0, 12.0])


def test_list_append_in_traced_loop_raises_clearly():
    def case():
        @P.jit.to_static
        def f(x, n):
            outs = []
            i = P.to_tensor(0)
            while i < n:
                outs.append(x * 2.0)
                i = i + 1
            return outs
        with pytest.raises(ValueError,
                           match="container.*outs|outs.*container"):
            f(t([1.0]), P.to_tensor(3))
        return True
    both(case)


def test_golden_model_containers_and_early_return():
    nets = {}

    def case():
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fcs = P.nn.LayerList([P.nn.Linear(4, 4)
                                           for _ in range(3)])

            def forward(self, x, collect_all=False):
                feats = []
                h = x
                for i, fc in enumerate(self.fcs):
                    h = P.tanh(fc(h)) * float(i + 1)
                    feats.append(h)
                if collect_all:
                    out = P.concat(feats, axis=-1)
                    if out.sum() > 0:
                        return out * 2.0  # early exit, same shape as below
                    return out
                if h.sum() > 0:
                    return h * 2.0
                return h

        P.seed(0)
        net = Net()
        if P is tp:
            net.set_state_dict({k: v.numpy() for k, v in
                                nets["jax"].state_dict().items()})
        else:
            nets["jax"] = net
        rng = np.random.default_rng(0)
        static_fwd = P.jit.to_static(net.forward)
        out = []
        for shift in (2.0, -2.0):  # drive both sides of the traced return
            x = P.to_tensor(
                (rng.standard_normal((2, 4)) + shift).astype("float32"))
            for mode in (True, False):
                got = _np(static_fwd(x, collect_all=mode))
                np.testing.assert_allclose(
                    got, _np(net(x, collect_all=mode)), rtol=1e-5)
                out.append(got)
        return out
    both(case, rtol=1e-5)


def test_nested_if_converts_inside_unconvertible_loop():
    def case():
        @P.jit.to_static
        def f(x):
            n = 0
            while n < 3:
                if x.sum() > 0:
                    x = x - 1.0
                n = n + 1
                if n == 3:
                    return x
            return x
        return [_np(f(t([7.0]))), _np(f(t([-7.0])))]
    a, b = both(case)
    np.testing.assert_allclose(a, [4.0])
    np.testing.assert_allclose(b, [-7.0])


def test_static_leaf_type_distinguished():
    def case():
        @P.jit.to_static
        def f(x, mode):
            return x * 2.0 if isinstance(mode, bool) else x * 3.0
        x = t([1.0])
        return [_np(f(x, True)), _np(f(x, 1))]
    a, b = both(case)
    np.testing.assert_allclose(a, [2.0])
    np.testing.assert_allclose(b, [3.0])


def test_assert_on_traced_predicate_checks_at_runtime():
    def case():
        @P.jit.to_static
        def f(x):
            assert (x > 0).all(), "x must be positive"
            return x * 2.0
        out = _np(f(t([1.0, 2.0])))
        with pytest.raises(Exception, match="x must be positive"):
            o = f(t([-1.0, 2.0]))
            np.asarray(o.numpy())  # sync: callback errors surface here
        return out
    np.testing.assert_allclose(both(case), [2.0, 4.0])


def test_assert_concrete_keeps_python_semantics():
    def case():
        @P.jit.to_static
        def f(x, n):
            assert n > 0, "n must be positive"
            return x * float(n)
        x = t([3.0])
        out = _np(f(x, 2))
        with pytest.raises(AssertionError, match="n must be positive"):
            f(x, 0)
        return out
    np.testing.assert_allclose(both(case), [6.0])


def test_port_traced_if_lowers_to_torch_cond():
    """The port's capture holds a ``torch.cond`` node for a tensor
    predicate and none for a Python one."""
    global P
    P = tp

    @tp.jit.to_static
    def f(x, flag):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = -x
        if flag:
            y = y + 1.0
        return y
    f(t([1.0]), True)
    targets = [str(n.target) for n in f.program().graph.nodes]
    assert sum("cond" in s for s in targets) == 1
    P = None
    assert torch.equal(f(tp.to_tensor(np.array([-2.0], np.float32)),
                         False)._t, torch.tensor([2.0]))


def _nested_flow(x, n):
    if x.sum() > 0:
        if x.max() > 5.0:
            y = x * 3.0
        else:
            y = x * 2.0
    else:
        y = -x
    i = n - n
    while i < n:
        if y.sum() > 4.0:
            y = y * 0.5
        y = y + 1.0
        i = i + 1
    return y


def test_port_generated_closures_hold_no_locals_or_del(capsys):
    """A traced branch or loop body is traced by dynamo, which follows
    neither ``locals()`` nor ``del``: the closures the port generates use
    neither (the enclosing function keeps the seeds and the cleanups)."""
    import ast
    tp.jit.set_code_level(1)
    try:
        conv = td2s.convert_to_static(_nested_flow)
    finally:
        tp.jit.set_code_level(0)
    src = capsys.readouterr().out.split("---\n", 1)[1]
    tree = ast.parse(src)
    closures = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                and f.name.startswith("__ptt_")]
    assert len(closures) >= 6
    for f in closures:
        for node in ast.walk(f):
            assert not isinstance(node, ast.Delete), f.name
            assert not (isinstance(node, ast.Call)
                        and getattr(node.func, "id", None) == "locals"), \
                f.name
    global P
    P = tp
    for v, n in (([3.0, 4.0], 2), ([-1.0, 0.5], 3), ([0.1, 0.2], 0)):
        x = t(v)
        want = _nested_flow(x, tp.to_tensor(n)).numpy()
        np.testing.assert_allclose(conv(x, tp.to_tensor(n)).numpy(), want)
        got = tp.jit.to_static(_nested_flow)(x, tp.to_tensor(n)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    P = None
