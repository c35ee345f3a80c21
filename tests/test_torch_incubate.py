"""The port's ``incubate`` on the CPU against the JAX package: every fused
functional, the fused layers, LookAhead, ModelAverage,
DistributedFusedLamb, the autograd re-exports, the softmax-mask
fusions, the graph aliases, ``graph_khop_sampler`` and
``identity_loss``.

f32 throughout: outputs and the gradients of ``Σ out * w`` w.r.t. the
inputs and every parameter at 1e-4 (the JAX layer's weights carried
across by ``set_state_dict``); the optimizers' parameters after every
step at 1e-5.  Dropout draws differ by construction (each package's
generator), so the dropout paths run at rate 0 or in eval mode, and
``fused_dropout_add``'s training draw is held to its law.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_nn_cases import compare_runs, pair_run


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class _Fn:
    """A parameterless layer calling ``fn(P, *inputs)``."""

    @staticmethod
    def build(fn):
        def make(P):
            class Call(P.nn.Layer):
                def forward(self, *xs):
                    return fn(P, *xs)
            return Call()
        return make


def _run_fn(fn, arrays):
    compare_runs(pair_run(_Fn.build(fn), arrays,
                          lambda P, lay, xs: lay(*xs)))


FUNCTIONALS = {
    "fused_matmul_bias": (lambda P, x, y, b: P.incubate.nn.functional
                          .fused_matmul_bias(x, y, b, transpose_y=True),
                          [(2, 3, 4), (5, 4), (5,)]),
    "fused_matmul_bias-tx": (lambda P, x, y: P.incubate.nn.functional
                             .fused_matmul_bias(x, y, transpose_x=True),
                             [(4, 3), (4, 5)]),
    "fused_linear": (lambda P, x, w, b: P.incubate.nn.functional
                     .fused_linear(x, w, b), [(2, 3, 4), (4, 5), (5,)]),
    "swiglu-halves": (lambda P, x: P.incubate.nn.functional.swiglu(x),
                      [(2, 3, 8)]),
    "swiglu-two": (lambda P, x, y: P.incubate.nn.functional.swiglu(x, y),
                   [(2, 4), (2, 4)]),
    "fused_dropout_add-eval": (lambda P, x, y: P.incubate.nn.functional
                               .fused_dropout_add(x, y, 0.5,
                                                  training=False),
                               [(2, 4), (2, 4)]),
    "rope-neox": (lambda P, q, k, v, s, c: P.incubate.nn.functional
                  .fused_rotary_position_embedding(q, k, v, sin=s, cos=c),
                  [(2, 3, 2, 8), (2, 3, 2, 8), (2, 3, 2, 8), (3, 1, 8),
                   (3, 1, 8)]),
    "rope-interleaved": (lambda P, q, s, c: P.incubate.nn.functional
                         .fused_rotary_position_embedding(
                             q, sin=s, cos=c, use_neox_rotary_style=False),
                         [(2, 3, 2, 8), (3, 1, 8), (3, 1, 8)]),
    "softmax_mask_fuse": (lambda P, x, m: P.incubate.softmax_mask_fuse(x, m),
                          [(2, 2, 4, 4), (2, 1, 4, 4)]),
    "softmax_mask_fuse_upper_triangle":
        (lambda P, x: P.incubate.softmax_mask_fuse_upper_triangle(x),
         [(2, 2, 4, 4)]),
    "identity_loss-sum": (lambda P, x: P.incubate.identity_loss(x, 1),
                          [(3, 4)]),
    "identity_loss-mean": (lambda P, x: P.incubate.identity_loss(x, "mean"),
                           [(3, 4)]),
    "identity_loss-none": (lambda P, x: P.incubate.identity_loss(x),
                           [(3, 4)]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functional_matches_the_reference(name):
    fn, shapes = FUNCTIONALS[name]
    rng = np.random.default_rng(0)
    _run_fn(fn, [_n(rng, *s) for s in shapes])


def test_fused_dropout_add_training_follows_its_law():
    tpaddle.seed(1)
    x = tpaddle.ones([200, 100])
    y = tpaddle.zeros([200, 100])
    out = tpaddle.incubate.nn.functional.fused_dropout_add(x, y, p=0.3)
    a = out.numpy()
    np.testing.assert_allclose(np.unique(a), [0.0, 1 / 0.7], rtol=1e-6)
    assert abs((a == 0).mean() - 0.3) < 0.02


@pytest.mark.parametrize("pre_layer_norm", [False, True])
def test_fused_multi_head_attention_and_feedforward(pre_layer_norm):
    rng = np.random.default_rng(2)
    E, nh, hd, F_ = 8, 2, 4, 16
    x = _n(rng, 2, 4, E)
    qkv_w, qkv_b = _n(rng, 3, nh, hd, E) * 0.3, _n(rng, 3, nh, hd)
    lin_w, lin_b = _n(rng, E, E) * 0.3, _n(rng, E)
    ln = [_n(rng, E) for _ in range(4)]
    mask = _n(rng, 4, 4)

    def mha(P, x, qw, qb, lw, lb, s1, b1, s2, b2, m):
        return P.incubate.nn.functional.fused_multi_head_attention(
            x, qw, lw, pre_layer_norm=pre_layer_norm, pre_ln_scale=s1,
            pre_ln_bias=b1, ln_scale=s2, ln_bias=b2, qkv_bias=qb,
            linear_bias=lb, attn_mask=m, dropout_rate=0.0,
            attn_dropout_rate=0.0)
    _run_fn(mha, [x, qkv_w, qkv_b, lin_w, lin_b] + ln + [mask])

    w1, b1, w2, b2 = _n(rng, E, F_), _n(rng, F_), _n(rng, F_, E), _n(rng, E)

    def ffn(P, x, w1, w2, b1, b2, s1, c1, s2, c2):
        return P.incubate.nn.functional.fused_feedforward(
            x, w1, w2, b1, b2, s1, c1, s2, c2, dropout1_rate=0.0,
            dropout2_rate=0.0, activation="gelu",
            pre_layer_norm=pre_layer_norm)
    _run_fn(ffn, [x, w1, w2, b1, b2] + ln)


def _csr(B, H, M, rng, empty_row=2):
    """A random CSR pattern a (batch, head); row ``empty_row`` empty."""
    offs, cols = [], []
    for _ in range(B * H):
        per = rng.integers(1, M + 1, M)
        per[empty_row] = 0
        c = [np.sort(rng.choice(M, k, replace=False)) for k in per]
        offs.append(np.concatenate([[0], np.cumsum(per)]))
        cols.append(np.concatenate(c))
    nnz = max(len(c) for c in cols)
    cols = [np.pad(c, (0, nnz - len(c))) for c in cols]
    for o in offs:
        o[-1] = nnz        # the padded tail belongs to the last row
    return (np.stack(offs).reshape(B, H, M + 1).astype(np.int32),
            np.stack(cols).reshape(B, H, nnz).astype(np.int32))


@pytest.mark.parametrize("masks", [False, True])
def test_sparse_attention_matches_the_reference(masks):
    rng = np.random.default_rng(3)
    B, H, M, D = 2, 2, 5, 4
    q, k, v = _n(rng, B, H, M, D), _n(rng, B, H, M, D), _n(rng, B, H, M, D)
    off, cols = _csr(B, H, M, rng)
    kpm = (rng.uniform(size=(B, M)) > 0.2).astype(np.float32)
    am = (rng.uniform(size=(M, M)) > 0.2).astype(np.float32)

    def fn(P, q, k, v, off, cols):
        return P.nn.functional.sparse_attention(
            q, k, v, off, cols,
            key_padding_mask=P.to_tensor(kpm) if masks else None,
            attn_mask=P.to_tensor(am) if masks else None)
    _run_fn(fn, [q, k, v, off, cols])
    out = tpaddle.nn.functional.sparse_attention(
        *[tpaddle.to_tensor(a) for a in (q, k, v, off, cols)])
    assert not np.any(out.numpy()[:, :, 2])      # the empty row is zero


LAYERS = {
    "FusedMultiHeadAttention": (lambda P: P.incubate.nn
                                .FusedMultiHeadAttention(
                                    8, 2, dropout_rate=0.0,
                                    attn_dropout_rate=0.0),
                                [(2, 4, 8)]),
    "FusedMultiHeadAttention-pre": (lambda P: P.incubate.nn
                                    .FusedMultiHeadAttention(
                                        8, 2, dropout_rate=0.0,
                                        attn_dropout_rate=0.0,
                                        normalize_before=True),
                                    [(2, 4, 8), (4, 4)]),
    "FusedFeedForward": (lambda P: P.incubate.nn.FusedFeedForward(
        8, 16, dropout_rate=0.0), [(2, 4, 8)]),
    "FusedTransformerEncoderLayer": (lambda P: P.incubate.nn
                                     .FusedTransformerEncoderLayer(
                                         8, 2, 16, dropout_rate=0.0),
                                     [(2, 4, 8), (4, 4)]),
    "FusedTransformerEncoderLayer-eval": (
        lambda P: P.incubate.nn.FusedTransformerEncoderLayer(
            8, 2, 16, normalize_before=True).eval(), [(2, 4, 8)]),
    "FusedLinear": (lambda P: P.incubate.nn.FusedLinear(4, 6), [(2, 3, 4)]),
    "FusedLinear-t": (lambda P: P.incubate.nn.FusedLinear(
        4, 6, transpose_weight=True), [(2, 4)]),
    "FusedEcMoe-gelu": (lambda P: P.incubate.nn.FusedEcMoe(4, 8, 3, "gelu"),
                        [(2, 3, 4), (2, 3, 3)]),
    "FusedEcMoe-relu": (lambda P: P.incubate.nn.FusedEcMoe(4, 8, 3, "relu"),
                        [(2, 3, 4), (2, 3, 3)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fused_layer_matches_the_reference(name):
    build, shapes = LAYERS[name]
    rng = np.random.default_rng(4)
    compare_runs(pair_run(build, [_n(rng, *s) for s in shapes],
                          lambda P, lay, xs: lay(*xs)))


# -- the optimizers ----------------------------------------------------------

SHAPES = [(4, 3), (3,)]


def _params(P, rng):
    init = P.nn.initializer.Assign
    return [P.create_parameter(list(s), "float32",
                               default_initializer=init(_n(rng, *s)))
            for s in SHAPES]


def _drive(P, make, steps=6, seed=5):
    """``steps`` steps on fixed gradients; the params after each."""
    rng = np.random.default_rng(seed)
    ps = _params(P, rng)
    opt = make(P, ps)
    traj = []
    for _ in range(steps):
        for p in ps:
            p.grad = P.to_tensor(_n(rng, *p.shape))
        opt.step()
        opt.clear_grad()
        traj.append([np.asarray(p.numpy()) for p in ps])
    return traj, opt, ps


OPTS = {
    "LookAhead-SGD": lambda P, ps: P.incubate.LookAhead(
        P.optimizer.SGD(0.1, parameters=ps), alpha=0.5, k=3),
    "LookAhead-AdamW": lambda P, ps: P.incubate.optimizer.LookAhead(
        P.optimizer.AdamW(0.01, parameters=ps), alpha=0.8, k=2),
    "DistributedFusedLamb": lambda P, ps: P.incubate.optimizer
    .DistributedFusedLamb(0.01, parameters=ps),
    "DistributedFusedLamb-acc2": lambda P, ps: P.incubate.optimizer
    .DistributedFusedLamb(0.01, parameters=ps,
                          gradient_accumulation_steps=2),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_the_reference(name):
    jt, _, _ = _drive(jpaddle, OPTS[name])
    tt, _, _ = _drive(tpaddle, OPTS[name])
    for step, (a, b) in enumerate(zip(tt, jt)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step}")


def test_model_average_apply_and_restore():
    res = {}
    for P in (jpaddle, tpaddle):
        def make(P_, ps):
            inner = P_.optimizer.SGD(0.1, parameters=ps)
            avg = P_.incubate.ModelAverage(0.15, parameters=ps,
                                           max_average_window=4)

            class Both:
                def step(self):
                    inner.step()
                    avg.step()

                def clear_grad(self):
                    inner.clear_grad()
            both = Both()
            both.avg = avg
            return both
        traj, opt, ps = _drive(P, make, steps=6)
        with opt.avg.apply():
            averaged = [np.asarray(p.numpy()) for p in ps]
        restored = [np.asarray(p.numpy()) for p in ps]
        res[P.__name__] = (traj, averaged, restored)
    (jt, ja, jr), (tt, ta, tr) = res["paddle_tpu"], res["paddle_tpu_torch"]
    for a, b in zip(ta + tr + tt[-1], ja + jr + jt[-1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(tr, tt[-1]):
        np.testing.assert_array_equal(a, b)     # restore gives them back
    assert not all(np.array_equal(a, b) for a, b in zip(ta, tr))


# -- autograd, graphs --------------------------------------------------------

def test_autograd_reexports_and_prim_toggles():
    ag = tpaddle.incubate.autograd
    from paddle_tpu_torch.autograd import functional as taf
    assert ag.jacobian is taf.jacobian and ag.hessian is taf.hessian
    assert ag.vjp is taf.vjp and ag.jvp is taf.jvp
    assert not ag.prim_enabled()
    ag.enable_prim()
    assert ag.prim_enabled()
    ag.disable_prim()
    assert not ag.prim_enabled()
    x = tpaddle.to_tensor(np.array([1.0, 2.0], np.float32))
    j = ag.jacobian(lambda a: a * a, x)
    jj = jpaddle.incubate.autograd.jacobian(
        lambda a: a * a, jpaddle.to_tensor(np.array([1.0, 2.0], np.float32)))
    np.testing.assert_allclose(np.asarray(j.numpy()),
                               np.asarray(jj.numpy()), rtol=1e-6)


def test_graph_aliases_and_khop_sampler():
    inc = tpaddle.incubate
    import paddle_tpu_torch.geometric as tg
    assert inc.graph_send_recv is tg.send_u_recv
    assert inc.graph_sample_neighbors is tg.sample_neighbors
    assert inc.graph_reindex is tg.reindex_graph
    assert inc.segment_sum is tg.segment_sum
    # a CSC graph of 6 nodes
    row = np.array([1, 2, 0, 3, 4, 0, 5, 1, 2, 3], np.int64)
    colptr = np.array([0, 2, 5, 7, 8, 9, 10], np.int64)
    nodes = np.array([0, 2], np.int64)
    out = {}
    for P in (jpaddle, tpaddle):
        np.random.seed(11)
        res = P.incubate.graph_khop_sampler(
            P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes),
            [2, 2])
        out[P.__name__] = [np.asarray(r.numpy()).astype(np.int64)
                           for r in res]
    for a, b in zip(out["paddle_tpu_torch"], out["paddle_tpu"]):
        np.testing.assert_array_equal(a, b)
    ids = tpaddle.to_tensor(np.array([0, 0, 1], np.int64))
    data = tpaddle.to_tensor(np.array([[1.0], [2.0], [4.0]], np.float32))
    np.testing.assert_array_equal(inc.segment_sum(data, ids).numpy(),
                                  [[3.0], [4.0]])


def test_incubate_surface():
    names = set(tpaddle.incubate.__all__)
    want = set(jpaddle.incubate.__all__)
    assert names == want
    for n in names:
        assert hasattr(tpaddle.incubate, n), n
    assert set(tpaddle.incubate.optimizer.__all__) == \
        set(jpaddle.incubate.optimizer.__all__)
    assert tpaddle.nn.functional.sparse_attention is \
        tpaddle.incubate.nn.functional.sparse_attention
    assert isinstance(tpaddle.incubate.nn.FusedLinear(2, 2).weight._t,
                      torch.Tensor)
