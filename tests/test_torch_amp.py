"""The port's ``amp`` (``auto_cast`` through ``apply_op``'s cast hook,
``decorate`` O2 with float32 master weights, ``GradScaler``) on the CPU
against the JAX package.

Tolerances: outputs of an op run in bf16 are compared at 2e-2 relative
and absolute (two ulps of bf16 at 1, its 8-bit mantissa; each package
rounds its own bf16 products), float32 ones at 1e-5.  The O2 Llama runs
in bf16, so its losses agree to 1e-3 relative; its SGD / Momentum
master weights to 2 bf16 ulps of the largest weight and AdamW's, which
moves a weight by about lr a step whatever its gradient's size (a bf16
gradient near 0 may differ in sign), to 3 steps × 2 lr; the moments and
velocities, sums of gradients that come out of bf16 products through
the whole backward in either package, to 8 bf16 ulps of the largest.

The reference casts an op's inputs outside its vjp, so its tape refuses
a float32 cotangent for a bf16 output (``test_reference_tape_refuses_a_
list_cast``): whenever a cast sits between two ops, its backward
raises.  The port's cast is a node of torch's graph.  Where a run needs
that backward, the reference side spells the cast out with ``astype``
(which its tape differentiates) outside ``auto_cast``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core import tensor as jtensor
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.core import tensor as ttensor
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch import flags as tflags

BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _pos(rng, *shape):
    return rng.uniform(0.1, 0.9, shape).astype(np.float32)


# every list name with an op of the port that passes it (cos_sim and
# softmax_with_cross_entropy: no op of either package passes the name;
# their functionals are held here as the reference runs them)
LIST_OPS = {
    "matmul": lambda P, a: P.matmul(a, a),
    "bmm": lambda P, a: P.bmm(P.reshape(a, [1, 4, 4]),
                              P.reshape(a, [1, 4, 4])),
    "mv": lambda P, a: P.mv(a, P.sum(a, axis=0)),
    "linear": lambda P, a: P.nn.functional.linear(a, a),
    "conv1d": lambda P, a: P.nn.functional.conv1d(
        P.reshape(a, [1, 4, 4]), P.reshape(a, [4, 4, 1])),
    "conv2d": lambda P, a: P.nn.functional.conv2d(
        P.reshape(a, [1, 1, 4, 4]), P.reshape(a, [4, 1, 2, 2])),
    "conv3d": lambda P, a: P.nn.functional.conv3d(
        P.reshape(a, [1, 1, 2, 2, 4]), P.reshape(a, [2, 1, 2, 2, 2])),
    "conv1d_transpose": lambda P, a: P.nn.functional.conv1d_transpose(
        P.reshape(a, [1, 4, 4]), P.reshape(a, [4, 2, 2])),
    "conv2d_transpose": lambda P, a: P.nn.functional.conv2d_transpose(
        P.reshape(a, [1, 1, 4, 4]), P.reshape(a, [1, 4, 2, 2])),
    "conv3d_transpose": lambda P, a: P.nn.functional.conv3d_transpose(
        P.reshape(a, [1, 1, 2, 2, 4]), P.reshape(a, [1, 2, 2, 2, 2])),
    "einsum": lambda P, a: P.einsum("ij,jk->ik", a, a),
    "scaled_dot_product_attention":
        lambda P, a: P.nn.functional.scaled_dot_product_attention(
            P.reshape(a, [1, 4, 1, 4]), P.reshape(a, [1, 4, 1, 4]),
            P.reshape(a, [1, 4, 1, 4])),
    "exp": lambda P, a: P.exp(a),
    "square": lambda P, a: P.square(a),
    "log": lambda P, a: P.log(a),
    "log2": lambda P, a: P.log2(a),
    "log10": lambda P, a: P.log10(a),
    "log1p": lambda P, a: P.log1p(a),
    "mean": lambda P, a: P.mean(a, axis=0),
    "sum": lambda P, a: P.sum(a, axis=0),
    "cos_sim": lambda P, a: P.nn.functional.cosine_similarity(a, a),
    "softmax": lambda P, a: P.nn.functional.softmax(a),
    "log_softmax": lambda P, a: P.nn.functional.log_softmax(a),
    "softmax_with_cross_entropy":
        lambda P, a: P.nn.functional.softmax_with_cross_entropy(
            a, P.to_tensor(np.array([[0], [1], [2], [3]]))),
    "cross_entropy": lambda P, a: P.nn.functional.cross_entropy(
        a, P.to_tensor(np.array([0, 1, 2, 3]))),
    "sigmoid_focal_loss": lambda P, a: P.nn.functional.sigmoid_focal_loss(
        a, P.round(a)),
    "binary_cross_entropy":
        lambda P, a: P.nn.functional.binary_cross_entropy(a, a),
    "cumsum": lambda P, a: P.cumsum(a, axis=1),
    "layer_norm": lambda P, a: P.nn.functional.layer_norm(a, 4),
    "batch_norm": lambda P, a: P.nn.functional.batch_norm(
        P.reshape(a, [1, 4, 4]), P.zeros([4]), P.ones([4])),
    "rms_norm": lambda P, a: P.nn.functional.rms_norm(a, 4),
    "norm": lambda P, a: P.norm(a),
    "logsumexp": lambda P, a: P.logsumexp(a, axis=1),
    "erf": lambda P, a: P.erf(a),
    "erfinv": lambda P, a: P.erfinv(a),
}
UNPASSED = {"cos_sim", "softmax_with_cross_entropy"}


def test_the_lists_are_the_references():
    from paddle_tpu import amp as jamp
    assert tpaddle.amp.WHITE_LIST == jamp.WHITE_LIST
    assert tpaddle.amp.BLACK_LIST == jamp.BLACK_LIST
    assert tpaddle.amp.white_list() == jamp.white_list()
    assert tpaddle.amp.black_list() == jamp.black_list()
    assert set(LIST_OPS) == jamp.WHITE_LIST | jamp.BLACK_LIST


def _recording(monkeypatch):
    """Record the op names both packages' hooks see."""
    seen = {"jax": [], "torch": []}
    jhook, thook = jtensor._AMP_CAST_HOOK[0], ttensor._AMP_CAST_HOOK[0]

    def jrec(name, arrays):
        seen["jax"].append(name)
        return jhook(name, arrays)

    def trec(name, inputs):
        seen["torch"].append(name)
        return thook(name, inputs)
    monkeypatch.setattr(jtensor, "_AMP_CAST_HOOK", [jrec])
    monkeypatch.setattr(ttensor, "_AMP_CAST_HOOK", [trec])
    return seen


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(LIST_OPS))
def test_list_op_casts_as_the_reference(name, level, monkeypatch):
    """Each list op on f32 input under O1 / O2: the op names the hook
    sees, the output's dtype and its value equal the reference's."""
    seen = _recording(monkeypatch)
    a = _pos(np.random.default_rng(0), 4, 4)
    outs = {}
    for key, P in (("jax", jpaddle), ("torch", tpaddle)):
        with P.amp.auto_cast(level=level):
            outs[key] = LIST_OPS[name](P, P.to_tensor(a))
    assert seen["torch"] == seen["jax"]
    if name not in UNPASSED:
        assert name in seen["torch"]
    j, t = outs["jax"], outs["torch"]
    assert _dt(t) == str(j.dtype)
    tol = BF16 if _dt(t) == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def test_no_cast_and_no_hook_call_while_amp_is_off(monkeypatch):
    def boom(name, inputs):
        raise AssertionError("the hook ran with AMP off")
    monkeypatch.setattr(ttensor, "_AMP_CAST_HOOK", [boom])
    a = tpaddle.to_tensor(_pos(np.random.default_rng(0), 4, 4))
    assert tpaddle.matmul(a, a).dtype == torch.float32
    assert not tpaddle.amp.amp_state().enabled


def test_cast_is_in_the_graph_and_non_tensor_inputs_pass():
    """A white op's f32 leaf gets its gradient in f32 (the bf16 grad's
    values); ints and Python values pass as they are."""
    rng = np.random.default_rng(1)
    x = tpaddle.to_tensor(_pos(rng, 3, 4), stop_gradient=False)
    w = tpaddle.to_tensor(_pos(rng, 4, 2), stop_gradient=False)
    with tpaddle.amp.auto_cast():
        y = tpaddle.matmul(x, w)
        idx = tpaddle.to_tensor(np.array([0, 2]))
        g = tpaddle.gather(y, idx)
    assert y.dtype == torch.bfloat16 and idx.dtype == torch.int64
    assert g.dtype == torch.bfloat16
    tpaddle.sum(y).backward()
    assert x.grad.dtype == torch.float32 and w.grad.dtype == torch.float32
    want = (np.ones((3, 2), np.float32) @ _np(w).T)
    np.testing.assert_allclose(_np(x.grad), want, **BF16)


def test_custom_lists_nesting_and_amp_guard():
    a = _pos(np.random.default_rng(2), 4, 4)
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(a)
        with P.amp.auto_cast(custom_white_list=["exp"],
                             custom_black_list=["matmul"]):
            assert "bfloat16" in str(P.exp(x).dtype)
            assert "float32" in str(P.matmul(x, x).dtype)
            with P.amp.auto_cast(enable=False):
                assert "float32" in str(P.matmul(x, x).dtype)
                with P.amp.amp_guard(dtype="float16"):
                    assert "float16" in str(P.matmul(x, x).dtype)
                    assert "float16" not in str(P.exp(x).dtype)
            assert "bfloat16" in str(P.exp(x).dtype)
        assert "float32" in str(P.matmul(x, x).dtype)
        assert P.amp.amp_guard is P.amp.auto_cast
    assert not tpaddle.amp.amp_state().enabled


def test_reference_tape_refuses_a_list_cast():
    """Linear (white) into layer_norm (black) under O1: the reference's
    backward raises, the port's runs and its gradients are those of the
    reference run with the cast spelled out."""
    rng = np.random.default_rng(3)
    xa = rng.standard_normal((2, 4)).astype(np.float32)
    jl, jn = jpaddle.nn.Linear(4, 4), jpaddle.nn.LayerNorm(4)
    tl, tn = tpaddle.nn.Linear(4, 4), tpaddle.nn.LayerNorm(4)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    with jpaddle.amp.auto_cast():
        y = jn(jl(jpaddle.to_tensor(xa)))
    with pytest.raises(ValueError, match="unexpected JAX type"):
        jpaddle.sum(y).backward()
    jl.clear_gradients()
    with jpaddle.amp.auto_cast():
        h = jl(jpaddle.to_tensor(xa))
    jpaddle.sum(jn(h.astype("float32"))).backward()
    with tpaddle.amp.auto_cast():
        ty = tn(tl(tpaddle.to_tensor(xa)))
    assert ty.dtype == torch.float32
    tpaddle.sum(ty).backward()
    assert tl.weight.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(tl.weight.grad), _np(jl.weight.grad),
                               **BF16)
    np.testing.assert_allclose(_np(tl.bias.grad), _np(jl.bias.grad), **BF16)


def _norm_model(P):
    nn = P.nn
    P.seed(4)
    return nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8), nn.ReLU(),
                         nn.Linear(8, 6), nn.BatchNorm1D(6))


def test_decorate_o2_keeps_norm_params_f32():
    a = np.random.default_rng(5).standard_normal((5, 4)).astype(np.float32)
    out = {}
    for key, P in (("jax", jpaddle), ("torch", tpaddle)):
        m = _norm_model(P)
        if P is tpaddle:
            m.set_state_dict({k: v for k, v in ref_sd.items()})
        else:
            ref_sd = {k: v.numpy() for k, v in m.state_dict().items()}
        opt = P.optimizer.SGD(0.1, parameters=m.parameters())
        m2, opt2 = P.amp.decorate(models=m, optimizers=opt, level="O2")
        assert m2 is m and opt2 is opt and opt._use_master_weights
        dts = {k: str(v.dtype).replace("torch.", "")
               for k, v in m.state_dict().items()}
        with P.amp.auto_cast(level="O2"):
            y = m(P.to_tensor(a))
        stats = {k: (_dt(v) if P is tpaddle else str(v.dtype), _np(v))
                 for k, v in m.state_dict().items() if "_" in k}
        out[key] = (dts, _np(y), str(y.dtype).replace("torch.", ""), stats)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["1.weight"] == "float32"
    assert out["torch"][0]["4.weight"] == "float32"
    assert out["torch"][0]["0.weight"] == "bfloat16"
    assert out["torch"][2] == out["jax"][2]
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], **BF16)
    # batch norm's running statistics: the reference updates them in ops
    # its hook casts to bf16, the port outside the op surface in f32
    for k, (dt, v) in out["torch"][3].items():
        assert dt == "float32" and out["jax"][3][k][0] == "bfloat16", k
        np.testing.assert_allclose(v, out["jax"][3][k][1], rtol=2 ** -7,
                                   atol=1e-6, err_msg=k)
    # the structure comes back as it went in; O1 changes nothing
    m = _norm_model(tpaddle)
    opt = tpaddle.optimizer.SGD(0.1, parameters=m.parameters())
    ms, opts = tpaddle.amp.decorate([m], [opt], level="O2",
                                    master_weight=False)
    assert ms == [m] and opts == [opt]
    assert not getattr(opt, "_use_master_weights", False)
    m1 = _norm_model(tpaddle)
    assert tpaddle.amp.decorate(m1, level="O1") is m1
    assert m1[0].weight.dtype == torch.float32
    with pytest.raises(ValueError, match="level"):
        tpaddle.amp.decorate(m1, level="O3")


LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=64)


def _o2_run(P, model, opt_name, ids, labels, steps=3):
    kw = dict(momentum=0.9) if opt_name == "Momentum" else {}
    opt = getattr(P.optimizer, opt_name)(
        learning_rate=1e-3, parameters=model.parameters(), **kw)
    model, opt = P.amp.decorate(models=model, optimizers=opt, level="O2")
    scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ids_t, lab_t = P.to_tensor(ids), P.to_tensor(labels)
    losses = []
    for _ in range(steps):
        if P is jpaddle:
            with P.amp.auto_cast(level="O2"):
                logits = model(ids_t)
            loss = P.nn.functional.cross_entropy(
                P.reshape(logits, [-1, LLAMA["vocab_size"]]).astype(
                    "float32"), P.reshape(lab_t, [-1]))
        else:
            with P.amp.auto_cast(level="O2"):
                loss, _ = model(ids_t, labels=lab_t)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    params = {k: (_dt(v) if P is tpaddle else str(v.dtype), _np(v))
              for k, v in model.state_dict().items()}
    sd = opt.state_dict()
    return losses, params, {k: _np(v) for k, v in sd.items()
                            if hasattr(v, "numpy")}, sorted(sd)


# each master's movement over the 3 steps (master less the cast initial
# weight) within this relative L2 distance of the reference's: a master
# that never moved is 1 away, one moved the wrong way 2 (measured on the
# CPU: AdamW 0.076, SGD 0.015, Momentum 0.014 -- the grads are bf16
# products summed in other orders, and Adam's first steps move a
# near-zero gradient's weight by +-lr whichever its sign); and the share
# of each bf16 parameter's elements within 2 bf16 ulps of the
# reference's (measured 0.962, 0.9996, 0.9994)
O2_MOVE_TOL = {"AdamW": 0.2, "SGD": 0.05, "Momentum": 0.05}
O2_PARAM_SHARE = {"AdamW": 0.9, "SGD": 0.99, "Momentum": 0.99}


@pytest.mark.parametrize("opt_name", ["AdamW", "SGD", "Momentum"])
def test_llama_o2_master_weights_match_the_reference(opt_name):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, LLAMA["vocab_size"], (2, 12)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(
        dtype=jnp.float32, use_remat=False, fused_blocks="off", **LLAMA))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(
        dtype=torch.float32, use_remat=False, **LLAMA))
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    # the masters start from the O2-cast weights
    init = {p.name: p._t.detach().to(torch.bfloat16).float().numpy()
            for p in tm.parameters()}
    jl, jp, jsd, jkeys = _o2_run(jpaddle, jm, opt_name, ids, labels)
    tl_, tp_, tsd, tkeys = _o2_run(tpaddle, tm, opt_name, ids, labels)
    assert tkeys == jkeys
    assert sum(k.endswith("_master_weight") for k in tkeys) == len(tp_)
    np.testing.assert_allclose(tl_, jl, rtol=1e-3)
    for k, (dt, v) in tp_.items():
        assert dt == "bfloat16" and jp[k][0] == "bfloat16", k
        want = jp[k][1]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                      - 7)
        share = float(np.mean(np.abs(v - want) <= 2 * ulp))
        assert share >= O2_PARAM_SHARE[opt_name], (k, share)
    lr = 1e-3
    for k in tsd:
        want = jsd[k]
        if not k.endswith("_master_weight"):     # moments, velocities
            atol = 2 ** -5 * np.abs(want).max() + 1e-6
        elif opt_name == "AdamW":
            atol = 6 * lr
        else:
            atol = 2 ** -7 * np.abs(want).max() + 1e-6
        np.testing.assert_allclose(tsd[k], want, rtol=0, atol=atol,
                                   err_msg=k)
        if k.endswith("_master_weight"):
            w0 = init[k[:-len("_master_weight")]]
            move, ref_move = tsd[k] - w0, want - w0
            assert np.abs(ref_move).max() > 0, k
            dist = np.linalg.norm(move - ref_move) / np.linalg.norm(ref_move)
            assert dist <= O2_MOVE_TOL[opt_name], (k, dist)
    # each parameter is the cast of its master
    names = {p.name: p for p in tm.parameters()}
    for n, p in names.items():
        m = torch.as_tensor(tsd[f"{n}_master_weight"])
        assert torch.equal(p._t, m.to(torch.bfloat16)), n


def test_master_weights_round_trip_through_state_dict():
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(
        dtype=torch.float32, use_remat=False, **LLAMA))
    opt = tpaddle.optimizer.AdamW(1e-3, parameters=tm.parameters())
    tpaddle.amp.decorate(tm, opt, level="O2")
    ids = tpaddle.to_tensor(np.arange(24).reshape(2, 12) % 128)
    for _ in range(2):
        with tpaddle.amp.auto_cast(level="O2"):
            loss, _ = tm(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
    sd = opt.state_dict()
    opt2 = tpaddle.optimizer.AdamW(1e-3, parameters=tm.parameters())
    opt2._use_master_weights = True
    opt2.set_state_dict(sd)
    for k, v in opt2.state_dict().items():
        if hasattr(v, "numpy"):
            assert v._t.dtype == torch.float32
            assert torch.equal(v._t, sd[k]._t), k


def test_f32_grad_of_a_bf16_param_reads_and_accumulates():
    """After ``unscale_`` a bf16 parameter's grad reads float32; a
    backward without ``clear_grad`` adds to it in float32; after
    ``clear_grad`` the next backward starts over in bf16."""
    w = tpaddle.create_parameter([4], "float32")
    w.set_value(np.arange(4, dtype=np.float32))
    opt = tpaddle.optimizer.SGD(0.1, parameters=[w])
    tpaddle.amp.decorate(tpaddle.nn.Layer(), opt, level="O2")
    w._t = w._t.detach().to(torch.bfloat16).requires_grad_(True)
    scaler = tpaddle.amp.GradScaler(init_loss_scaling=8.0)
    scaler.scale(tpaddle.sum(w * 3.0)).backward()
    assert w.grad.dtype == torch.bfloat16
    scaler.unscale_(opt)
    assert w.grad.dtype == torch.float32
    np.testing.assert_array_equal(_np(w.grad), np.full(4, 3.0))
    tpaddle.sum(w * 2.0).backward()
    assert w.grad.dtype == torch.float32
    np.testing.assert_array_equal(_np(w.grad), np.full(4, 5.0))
    opt.clear_grad()
    assert w.grad is None
    tpaddle.sum(w * 2.0).backward()
    assert w.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(w.grad), np.full(4, 2.0))


def _two_backwards_after_unscale(P):
    """A bf16 weight's grad after ``unscale_`` (3, f32), then two
    backwards with no read between them, of gradient 1 and 2**-8: bf16
    would round their sum to 1, the reference adds each to the f32
    grad."""
    lin = P.nn.Linear(4, 1, bias_attr=False)
    opt = P.optimizer.SGD(0.1, parameters=lin.parameters())
    lin, opt = P.amp.decorate(lin, opt, level="O2")
    scaler = P.amp.GradScaler(init_loss_scaling=8.0)

    def loss(c):
        with P.amp.auto_cast(level="O2"):
            y = lin(P.to_tensor(np.full((1, 4), c, np.float32)))
        return P.sum(y.astype("float32"))
    scaler.scale(loss(3.0)).backward()
    scaler.unscale_(opt)
    loss(1.0).backward()
    loss(2.0 ** -8).backward()
    g = lin.weight.grad
    return str(g.dtype).replace("torch.", ""), _np(g)


def test_backwards_after_unscale_add_each_in_float32():
    jdt, jg = _two_backwards_after_unscale(jpaddle)
    tdt, tg = _two_backwards_after_unscale(tpaddle)
    assert tdt == jdt == "float32"
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg, np.full((4, 1), 4.0 + 2.0 ** -8))


def _scaler_errors(P):
    w = P.create_parameter([2], "float32")
    w.set_value(np.array([0.5, -1.5], np.float32))
    opt = P.optimizer.SGD(0.1, parameters=[w])
    s = P.amp.GradScaler(init_loss_scaling=4.0)
    msgs = []

    def grad():
        opt.clear_grad()
        s.scale(P.sum(w * 1.0)).backward()
    grad()
    s.unscale_(opt)
    for bad in (lambda: s.unscale_(opt),):
        with pytest.raises(RuntimeError) as e:
            bad()
        msgs.append(str(e.value))
    s.step(opt)
    for bad in (lambda: s.unscale_(opt), lambda: s.step(opt)):
        with pytest.raises(RuntimeError) as e:
            bad()
        msgs.append(str(e.value))
    s.update()
    grad()
    s.step(opt)          # READY again after update(): unscales once
    s.update()
    return msgs, _np(w)


def test_grad_scaler_state_machine_errors_equal_the_reference():
    jm, jw = _scaler_errors(jpaddle)
    tm, tw = _scaler_errors(tpaddle)
    assert tm == jm and len(tm) == 3
    np.testing.assert_allclose(tw, jw, rtol=1e-6)
    off = tpaddle.amp.GradScaler(enable=False)
    x = tpaddle.to_tensor([2.0])
    assert off.scale(x) is x and not off.is_enable()
    assert off.state_dict() == {"enable": False}


def _mlp(P):
    P.seed(7)
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _fp16_trajectory(P, sd, x, steps=40):
    m = _mlp(P)
    if sd is not None:
        m.set_state_dict(sd)
    opt = P.optimizer.SGD(0.01, parameters=m.parameters())
    s = P.amp.GradScaler(init_loss_scaling=2.0 ** 32, incr_every_n_steps=3)
    xt = P.to_tensor(x)
    traj, skipped = [], []
    for _ in range(steps):
        before = [_np(p).copy() for p in m.parameters()]
        with P.amp.auto_cast(dtype="float16"):
            out = m(xt)
        loss = P.mean(P.square(out.astype("float32")))
        s.scale(loss).backward()
        s.step(opt)
        s.update()
        opt.clear_grad()
        after = [_np(p) for p in m.parameters()]
        same = all(np.array_equal(a, b) for a, b in zip(before, after))
        skipped.append(same)
        traj.append(s.get_init_loss_scaling())
    return traj, skipped, m, s


def test_fp16_dynamic_scaling_trajectory_equals_the_reference():
    x = np.random.default_rng(8).standard_normal((6, 8)).astype(np.float32)
    jm = _mlp(jpaddle)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    tmetrics.reset()
    tflags.set_flags({"FLAGS_tpu_metrics": True})
    try:
        jt, js, jmod, _ = _fp16_trajectory(jpaddle, None, x)
        tt, ts, tmod, ts_ = _fp16_trajectory(tpaddle, sd, x)
        snap = tmetrics.snapshot()
    finally:
        tflags.set_flags({"FLAGS_tpu_metrics": False})
        tmetrics.reset()
    assert tt == jt and ts == js
    n_skip = sum(ts)
    assert 10 < n_skip < 40 and not ts[-1] and ts[0]
    assert tt[:3] == [2.0 ** 31, 2.0 ** 30, 2.0 ** 29]
    assert snap["amp_skipped_steps_total"] == n_skip
    assert snap["amp_found_inf_total"] == n_skip
    assert snap["amp_loss_scale"] == tt[-1]
    for (k, a), (_, b) in zip(tmod.state_dict().items(),
                              jmod.state_dict().items()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_grad_scaler_state_dict_round_trip():
    x = np.random.default_rng(9).standard_normal((6, 8)).astype(np.float32)
    _, _, _, s = _fp16_trajectory(tpaddle, None, x, steps=30)
    sd = s.state_dict()
    j = jpaddle.amp.GradScaler()
    j.load_state_dict(sd)
    assert j.state_dict() == sd
    t = tpaddle.amp.GradScaler()
    t.load_state_dict(sd)
    assert t.state_dict() == sd and t.get_init_loss_scaling() == sd["scale"]
    off = tpaddle.amp.GradScaler()
    off.load_state_dict({"enable": False})
    assert not off.is_enable() and off.state_dict() == {"enable": False}
    assert sorted(sd) == sorted(jpaddle.amp.GradScaler().state_dict())
