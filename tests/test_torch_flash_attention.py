"""The port's flash attention (``paddle_tpu_torch.ops.flash_attention``)
against the JAX reference on the CPU.

- The plain forward against ``_attention_jnp`` and the plain backward
  against ``jax.vjp`` of it: float32, atol 2e-5 on the output and 2e-4 on
  the gradients (``tests/test_pallas_kernels.py``'s tolerances; both
  sides materialise the same S x S scores, the order of summation
  differs).
- The plain versions against the Pallas bodies run in interpret mode:
  the resident kernels at S = 512 and the streamed ones at S = 768
  (256 x 256 blocks), D = 128, including the reference's lane-replicated
  lse (its lane 0 equals the port's lse).  Same tolerances.
- ``causal_attention`` through torch autograd, and ``models.llama.
  _attention`` with GQA against the reference's ``_attention``.
- The kernels' argument checks, which are pure Python and run here.

Inputs are made from a seed with numpy and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import pallas_ops
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import flash_attention as fa

ATOL_OUT = 2e-5
ATOL_GRAD = 2e-4


def _inputs(B, S, H, D, seed, n=4):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((B, S, H, D)) * 0.5).astype(np.float32)
            for _ in range(n)]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _bh(x):
    """[B, S, H, D] numpy -> the reference kernels' [B*H, S, D]."""
    B, S, H, D = x.shape
    return jnp.asarray(np.swapaxes(x, 1, 2).reshape(B * H, S, D))


def _from_bh(x, B, H):
    BH, S, D = x.shape
    return np.swapaxes(np.asarray(x).reshape(B, H, S, D), 1, 2)


@pytest.fixture
def interpret():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


@pytest.mark.parametrize("B,S,H,D", [(2, 64, 3, 32), (1, 1, 2, 16),
                                     (1, 37, 1, 64)])
def test_plain_forward_matches_attention_jnp(B, S, H, D):
    q, k, v = _inputs(B, S, H, D, seed=S)[:3]
    o, lse = fa._flash_fwd_plain(*_t(q, k, v))
    ref = pallas_ops._attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL_OUT,
                               rtol=0)
    # lse = logsumexp over the causal scores, [B, H, S]
    s = np.einsum("bshd,bthd->bhst", q, k) / np.sqrt(D)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse_ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL_OUT, rtol=0)


@pytest.mark.parametrize("B,S,H,D", [(2, 64, 3, 32), (1, 37, 2, 64)])
def test_plain_backward_matches_jax_vjp(B, S, H, D):
    q, k, v, do = _inputs(B, S, H, D, seed=S + 1)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = fa._flash_fwd_plain(tq, tk, tv)
    got = fa._flash_bwd_plain(tq, tk, tv, o, lse, tdo)
    _, vjp = jax.vjp(pallas_ops._attention_jnp, jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    for g, r, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("variant,S", [("resident", 512), ("streamed", 768)])
def test_plain_versions_match_the_pallas_bodies(interpret, variant, S):
    B, H, D = 1, 2, 128
    q, k, v, do = _inputs(B, S, H, D, seed=S)
    fwd = getattr(pallas_ops, f"_flash_fwd_{variant}")
    bwd = getattr(pallas_ops, f"_flash_bwd_{variant}")
    qb, kb, vb, gb = (_bh(x) for x in (q, k, v, do))
    o_ref, lse_ref = fwd(qb, kb, vb, 256, 256)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = fa.flash_fwd(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), _from_bh(o_ref, B, H),
                               atol=ATOL_OUT, rtol=0)
    lse_ref = np.asarray(lse_ref)
    assert lse_ref.shape == (B * H, S, 128)
    np.testing.assert_array_equal(lse_ref, lse_ref[..., :1].repeat(128, -1))
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S),
                               lse_ref[..., 0], atol=ATOL_OUT, rtol=0)
    # both backwards run on the reference forward's o and lse
    ref = bwd(qb, kb, vb, gb, o_ref, jnp.asarray(lse_ref), 256, 256)
    o_t = torch.from_numpy(_from_bh(o_ref, B, H).copy())
    lse_t = torch.from_numpy(lse_ref[..., 0].reshape(B, H, S).copy())
    dq, delta = fa.flash_bwd_dq(tq, tk, tv, o_t, lse_t, tdo)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tdo, lse_t, delta)
    for g, r, name in zip((dq, dk, dv), ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), _from_bh(r, B, H),
                                   atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{name} {variant}")


def test_causal_attention_autograd_matches_jax():
    B, S, H, D = 2, 48, 2, 32
    q, k, v, do = _inputs(B, S, H, D, seed=5)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.causal_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    ref, vjp = jax.vjp(pallas_ops._attention_jnp, jnp.asarray(q),
                       jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL_OUT, rtol=0)
    for t, r in zip((tq, tk, tv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=ATOL_GRAD, rtol=0)


def test_gqa_attention_layer_matches_jax():
    """models.llama._attention (projections, rope, kv-head repeat,
    flash) with 4 q heads over 2 kv heads, output and gradients of x and
    every weight against the reference's _attention."""
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=64,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, use_remat=False,
                              fused_blocks="off", **kw)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **kw)
    rng = np.random.RandomState(11)
    S = 40
    lp = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64)}
    lp = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for n, s in lp.items()}
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    g = rng.standard_normal((2, S, 64)).astype(np.float32)
    jsin, jcos = jllama._rope_tables(jcfg, S)
    ref, vjp = jax.vjp(
        lambda lp_, x_: jllama._attention(jcfg, lp_, x_, jsin, jcos),
        {n: jnp.asarray(a) for n, a in lp.items()}, jnp.asarray(x))
    d_lp, d_x = vjp(jnp.asarray(g))
    tlp = {n: torch.from_numpy(a).requires_grad_() for n, a in lp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    sin, cos = tllama._rope_tables(tcfg, S, "cpu")
    out = tllama._attention(tcfg, tlp, tx, sin, cos)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(d_x),
                               atol=ATOL_GRAD, rtol=0)
    for n, t in tlp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(d_lp[n]),
                                   atol=ATOL_GRAD, rtol=0, err_msg=n)


def test_launch_counts_stay_put_on_the_cpu():
    q, k, v, do = _t(*_inputs(1, 8, 1, 16, seed=0))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do)
    fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


def test_other_devices_raise():
    q = torch.empty((1, 4, 1, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_bwd_dq(q, q, q, q, q, q)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_bwd_dkv(q, q, q, q, q, q)


@pytest.mark.parametrize("dtype,D,exc,match", [
    (torch.bfloat16, 128, None, None),
    (torch.bfloat16, 64, None, None),
    (torch.float32, 128, TypeError, "bfloat16"),
    (torch.float16, 64, TypeError, "bfloat16"),
    (torch.bfloat16, 96, ValueError, "head dim"),
    (torch.bfloat16, 256, ValueError, "head dim"),
])
def test_kernel_argument_checks(dtype, D, exc, match):
    q = torch.zeros((2, 5, 3, D), dtype=dtype)
    if exc is None:
        assert fa._check_kernel_args("flash_fwd", q, q, q) == (2, 5, 3, D)
    else:
        with pytest.raises(exc, match=match):
            fa._check_kernel_args("flash_fwd", q, q, q)


def test_kernel_argument_checks_reject_mismatched_operands():
    q = torch.zeros((2, 5, 3, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        fa._check_kernel_args("flash_fwd", q, q[:, :4], q)
    with pytest.raises(ValueError, match="does not match"):
        fa._check_kernel_args("flash_fwd", q, q, q.float())
    with pytest.raises(ValueError, match=r"\[B, S, H, D\]"):
        fa._check_kernel_args("flash_fwd", q[0], q[0], q[0])
