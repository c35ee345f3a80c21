"""The port's fused decoder blocks (``paddle_tpu_torch.ops.fused_blocks``)
against the JAX reference's Pallas kernels on the CPU.

The JAX side runs its fused kernels in interpret mode
(``pallas_ops._INTERPRET = True`` in a fixture, restored after, as
``tests/test_pallas_fused.py`` does) at ``fused_parity_cases``' shapes:
B = 1, S = 256, H = 256 (2 heads of 128), I = 512, float32, with the
block sizes the reference picks for them.  Inputs are made from a seed
with numpy and handed to both packages.

- Each plain kernel function against its Pallas kernel called directly:
  ``_fused_qkv_proj``, ``_fused_attn_epilogue`` (y, attn, and lane 0 of
  the reference's lane-replicated lse; at head dim 64, which the Pallas
  body does not take, the reference's jnp composition), and
  ``_fused_mlp_pallas`` "fwd" and "bwd_dx" (also at I = 640, an odd
  multiple of 128, which the reference's block picker takes: the CUDA
  kernels' odd and partial tiles).  Forward atol 2e-5 (f32
  summation order); dx atol 2e-5 + rtol 1e-3 (a sum over I of
  products).
- ``fused_attention_block`` / ``fused_mlp_block`` forward and the
  gradient of every differentiable input, through torch autograd,
  against ``jax.vjp`` of the reference's fused blocks (custom VJP,
  Pallas in interpret mode).  Output atol 2e-5; gradients atol 1e-4 +
  rtol 1e-3 (each is a sum over all B*S tokens of f32 products).
- The wrappers' routing (CPU tensors: the plain version, no launch
  counted; other devices raise) and the kernels' argument checks, which
  are pure Python and run here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ops
from paddle_tpu_torch.ops import fused_blocks as fb

B, S, H, D, I = 1, 256, 256, 128, 512
EPS = 1e-6
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _rope_np(S, D):
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))
    ang = np.arange(S, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([ang, ang], axis=-1)
    return np.sin(emb).astype(np.float32), np.cos(emb).astype(np.float32)


def _attn_args(seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, H)) * 0.5).astype(np.float32)
    ln = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    ws = [(rng.standard_normal((H, H)) * 0.05).astype(np.float32)
          for _ in range(4)]
    return [x, ln, *ws, *_rope_np(S, D)]


def _mlp_args(seed, inter=I):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, H)) * 0.5).astype(np.float32)
    ln = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    wg = (rng.standard_normal((H, inter)) * 0.05).astype(np.float32)
    wu = (rng.standard_normal((H, inter)) * 0.05).astype(np.float32)
    wd = (rng.standard_normal((inter, H)) * 0.05).astype(np.float32)
    return [x, ln, wg, wu, wd]


def _dy(seed, shape=(B, S, H)):
    return (np.random.RandomState(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _close(got, ref, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


# (atol, rtol) of q, k, v per dtype.  f32: the summation order of the
# products.  bf16: the two sides sum the f32 products in another order,
# so t = bf16(xn w) can round the other way (one bf16 ulp, 2^-8 of |t|),
# and rope carries that flip through its bf16 products and sum: 2^-7 of
# the value plus a floor for values near zero.
QKV_TOL = {"float32": (ATOL, 0.0), "bfloat16": (1e-2, 2 ** -7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,seq", [(128, S), (64, S), (128, 200),
                                    (64, 77)])
def test_qkv_plain_matches_the_pallas_kernel(hd, seq, dtype):
    """Both head dims the port's kernels take, S a multiple of the
    reference's row block and ragged (200, 77: no multiple of the CUDA
    kernel's 128-row tile), f32 and bf16 (where the rope rounding that
    the kernel copies shows).  The reference is the Pallas body in
    interpret mode at the blocks it picks where it takes the shape (D =
    128, S = 256); elsewhere ``_fused_attn_config`` is None and the
    reference's ``fused_attention_block`` takes its jnp composition, so
    that is the reference there: ``_rope_flat(_rms_norm_ref(x) w)``."""
    x, ln, wq, wk, wv, _, _, _ = _attn_args(0)
    x = np.ascontiguousarray(x[:, :seq])
    sin, cos = _rope_np(seq, hd)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    args = [x, ln, wq, wk, wv]
    cfg = pallas_ops._fused_attn_config(seq, H, hd, jdt)
    assert (cfg is not None) == ((hd, seq) == (D, S))
    ja = [a.astype(jdt) for a in _j(*args)]
    js, jc = _j(sin, cos)
    if cfg is not None:
        ref = pallas_ops._fused_qkv_proj(ja[0], ja[1].reshape(1, -1),
                                         *ja[2:], js, jc, hd, cfg[0], EPS)
    else:
        xn = pallas_ops._rms_norm_ref(ja[0], ja[1], EPS)
        ref = (pallas_ops._rope_flat(xn @ ja[2], js, jc, hd),
               pallas_ops._rope_flat(xn @ ja[3], js, jc, hd), xn @ ja[4])
    before = fb.fused_qkv.launches
    got = fb.fused_qkv(*(t.to(tdt) for t in _t(*args)), *_t(sin, cos),
                       head_dim=hd, eps=EPS)
    assert fb.fused_qkv.launches == before     # the CPU counts no launch
    atol, rtol = QKV_TOL[dtype]
    for n, g, r in zip("qkv", got, ref):
        assert g.shape == (B, seq, H) and g.dtype == tdt
        _close(g.float().numpy(), np.asarray(r, np.float32), atol=atol,
               rtol=rtol, msg=n)


@pytest.mark.parametrize("hd", [64, 128])
def test_attn_epilogue_plain_matches_the_pallas_kernel(hd):
    """Both head dims the port's kernels take.  At D = 128 the reference
    is its Pallas body at the blocks it picks, (128, 128).  Its body
    does not take D = 64 (it tiles the row statistics over 128 lanes),
    and there its ``fused_attention_block`` takes the jnp composition
    instead; so at D = 64 the reference is that composition's epilogue,
    ``x + _attention_jnp(q, k, v) wo``, and the lse the logsumexp of the
    causal scores."""
    x, _, _, _, _, wo, _, _ = _attn_args(1)
    rng = np.random.RandomState(2)
    q, k, v = ((rng.standard_normal((B, S, H)) * 0.5).astype(np.float32)
               for _ in range(3))
    nh = H // hd
    if hd == D:
        bq, bk = pallas_ops._fused_attn_config(S, H, hd, jnp.float32)
        y_r, attn_r, lse_r = pallas_ops._fused_attn_epilogue(
            *_j(q, k, v, x, wo), hd, bq, bk)
        lse_r = np.asarray(lse_r)[..., 0]
    else:
        assert pallas_ops._fused_attn_config(S, H, hd, jnp.float32) is None
        attn_r = pallas_ops._attention_jnp(
            *(jnp.asarray(t.reshape(B, S, nh, hd)) for t in (q, k, v))
        ).reshape(B, S, H)
        y_r = jnp.asarray(x) + attn_r @ jnp.asarray(wo)
        s = np.einsum("bshd,bthd->bhst", q.reshape(B, S, nh, hd),
                      k.reshape(B, S, nh, hd)) / np.sqrt(hd)
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
        m = s.max(-1, keepdims=True)
        lse_r = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    y, attn, lse = fb.fused_attn_epilogue(*_t(q, k, v, x, wo), head_dim=hd)
    _close(y.numpy(), y_r, msg="y")
    _close(attn.numpy(), attn_r, msg="attn")
    assert lse.shape == (B, nh, S) and lse.dtype == torch.float32
    _close(lse.numpy(), lse_r, msg="lse")


@pytest.mark.parametrize("which,inter", [
    pytest.param("fwd", I, id="fwd"),
    pytest.param("bwd_dx", I, id="bwd_dx"),
    # an odd multiple of 128: the CUDA kernels' partial and odd tiles
    pytest.param("fwd", 640, id="fwd-I640"),
    pytest.param("bwd_dx", 640, id="bwd_dx-I640"),
])
def test_mlp_plain_matches_the_pallas_kernel(which, inter):
    x, ln, wg, wu, wd = _mlp_args(3, inter)
    bs, bi = pallas_ops._fused_mlp_config(S, H, inter, jnp.float32)
    kernel = {"fwd": pallas_ops._mlp_fused_kernel,
              "bwd_dx": pallas_ops._mlp_bwd_dx_kernel}[which]
    inputs = [x, ln.reshape(1, -1), wg, wu, wd]
    if which == "bwd_dx":
        inputs.append(_dy(4))
    ref = pallas_ops._fused_mlp_pallas(
        functools.partial(kernel, eps=EPS), tuple(_j(*inputs)), jnp.float32,
        S, H, inter, bs, bi, which)
    if which == "fwd":
        got = fb.fused_mlp_fwd(*_t(x, ln, wg, wu, wd), eps=EPS)
        _close(got.numpy(), ref)
    else:
        got = fb.fused_mlp_bwd_dx(*_t(x, ln, wg, wu, wd, inputs[-1]),
                                  eps=EPS)
        _close(got.numpy(), ref, rtol=1e-3)


def _block_grads_match(jfn, tfn, args, nargs_diff, dy):
    """Forward and the vjp of the first ``nargs_diff`` inputs."""
    y_r, pull = jax.vjp(lambda *a: jfn(*a, *_j(*args[nargs_diff:])),
                        *_j(*args[:nargs_diff]))
    grads_r = pull(jnp.asarray(dy))
    leaves = [t.requires_grad_(True) for t in _t(*args[:nargs_diff])]
    y = tfn(*leaves, *_t(*args[nargs_diff:]))
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _close(y.detach().numpy(), y_r, msg="y")
    for i, (g, r) in enumerate(zip(grads, grads_r)):
        _close(g.numpy(), r, atol=1e-4, rtol=1e-3, msg=f"grad {i}")


def test_fused_attention_block_and_grads_match_jax():
    args = _attn_args(5)
    _block_grads_match(
        functools.partial(pallas_ops.fused_attention_block, head_dim=D,
                          eps=EPS),
        functools.partial(fb.fused_attention_block, head_dim=D, eps=EPS),
        args, 6, _dy(6))


def test_fused_mlp_block_and_grads_match_jax():
    args = _mlp_args(7)
    _block_grads_match(
        functools.partial(pallas_ops.fused_mlp_block, eps=EPS),
        functools.partial(fb.fused_mlp_block, eps=EPS), args, 5, _dy(8))


def test_wrappers_refuse_other_devices():
    x, ln, wg, wu, wd = (t.to("meta") for t in _t(*_mlp_args(0)))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fb.fused_mlp_fwd(x, ln, wg, wu, wd)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fb.fused_mlp_bwd_dx(x, ln, wg, wu, wd, x)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fb.fused_attn_epilogue(x, x, x, x, ln, head_dim=D)


def _bf16(*ts):
    return [t.to(torch.bfloat16) for t in ts]


def test_kernel_argument_checks():
    """What the CUDA path refuses, checked before any launch (so the CPU
    reaches it): not bf16, shapes the tiles do not cover, a wrong
    operand shape, a non-contiguous operand, a head dim the flash
    kernels do not take."""
    x, ln, wg, wu, wd = _t(*_mlp_args(0))
    with pytest.raises(TypeError, match="bfloat16"):
        fb._fused_mlp_fwd_cuda(x, ln, wg, wu, wd, EPS)
    x, ln, wg, wu, wd = _bf16(x, ln, wg, wu, wd)
    with pytest.raises(ValueError, match="multiple of 128"):
        fb._fused_mlp_fwd_cuda(x, ln, wg[:, :100], wu[:, :100],
                               wd[:100], EPS)
    with pytest.raises(ValueError, match="w_down"):
        fb._fused_mlp_fwd_cuda(x, ln, wg, wu, wd[:, :128], EPS)
    with pytest.raises(ValueError, match="not contiguous"):
        fb._fused_mlp_bwd_dx_cuda(x, ln, wg, wu, wd,
                                  torch.cat([x, x], -1)[..., ::2], EPS)
    with pytest.raises(ValueError, match="multiple of 128"):
        fb._fused_mlp_fwd_cuda(x[..., :200], ln[:200], wg[:200], wu[:200],
                               wd[:, :200], EPS)
    xa, ln_a, wq, wk, wv, wo, sin, cos = _t(*_attn_args(0))
    xa, ln_a, wq, wk, wv, wo = _bf16(xa, ln_a, wq, wk, wv, wo)
    with pytest.raises(ValueError, match="head dim"):
        fb._fused_qkv_cuda(xa, ln_a, wq, wk, wv, sin, cos, 96, EPS)
    with pytest.raises(ValueError, match="sin"):
        fb._fused_qkv_cuda(xa, ln_a, wq, wk, wv, sin[:, :64], cos, D, EPS)
    with pytest.raises(ValueError, match="wo"):
        fb._fused_attn_epilogue_cuda(xa, xa, xa, xa, wo.t(), D)
