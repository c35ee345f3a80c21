"""The fused decoder blocks (the port of ``paddle_tpu/ops/pallas_ops.py``'s
fused section, lines 875-1582).

    fused_attention_block:  y = x + attn(rope(rms(x) wq), rope(rms(x) wk),
                                         rms(x) wv) wo
    fused_mlp_block:        y = x + (silu(rms(x) wg) * (rms(x) wu)) wd

Layout as at the reference: x, y, q, k, v, attn ``[B, S, H]`` with the
heads flattened (``[B, S, nh, D]`` contiguous, which the flash kernels
read as they are); weights ``[in, out]``; ln ``[H]``; sin, cos
``[S, D]`` f32; lse ``[B, nh, S]`` f32 (the reference's 128-lane copy
is not kept, as in ``flash_attention``).

Four wrappers, each with a plain integer ``launches`` count, one per
TPU kernel body:

- ``fused_qkv`` (``_qkv_fused_kernel``): RMSNorm, the three
  projections, rope on q and k;
- ``fused_attn_epilogue`` (``_attn_epi_kernel``): causal flash
  attention per head, then ``y = x + attn wo`` (f32 sum, one cast);
  returns (y, attn, lse);
- ``fused_mlp_fwd`` (``_mlp_fused_kernel``): the whole MLP block, g and
  u in f32, ``a`` cast to bf16 before the down product;
- ``fused_mlp_bwd_dx`` (``_mlp_bwd_dx_kernel``): dx of the MLP block,
  g and u recomputed, the RMSNorm backward and the residual.

CUDA tensors go to the hand-written kernels of ``csrc/fused_blocks.cu``
(bf16, H and I multiples of 128, head dim 64 or 128, contiguous; any
other input raises); ``fused_attn_epilogue``'s attention is the port's
flash forward kernel (``csrc/flash_attention.cu``), launched by the same
wrapper.  CPU tensors go to the plain versions, which follow the
kernels' rounding: products in f32 from the operands' values, cast to
the activation dtype where the kernels cast.  The one difference is the
dx product, whose f32 left operands (dg, du) the kernel rounds to bf16
for the tensor cores.

``fused_attention_block`` and ``fused_mlp_block`` are
``torch.autograd.Function``s with the reference's backward split: the
attention backward runs the flash backward (``flash_bwd``) on the
flat-head tensors, and ``dwo``, the attention-output gradient and the
prologue's gradients are plain PyTorch (the reference left them to
XLA); the MLP's dx comes from ``fused_mlp_bwd_dx``, its ln and weight
gradients from autograd of the plain composition with x fixed.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..profiler import numerics as _numerics
from . import _build
from . import flash_attention as fa

__all__ = ["fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd",
           "fused_mlp_bwd_dx", "fused_attention_block", "fused_mlp_block"]

_HEAD_DIMS = (64, 128)
_TILE = 128      # the kernels' N tile: H and I must be multiples of it


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card's yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def _rms_norm(x, w, eps):
    # fp32 norm, cast to the activation dtype, then the weight multiply
    # (pallas_ops.py:924, models.llama._rms_norm)
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _rope_flat(x, sin, cos, D):
    """Neox rope over the flat-head ``[B, S, nh * D]`` layout, in x's
    dtype with the tables cast to it (pallas_ops.py:932)."""
    B, S, H = x.shape
    xh = x.reshape(B, S, H // D, D)
    half = D // 2
    rot = torch.cat([-xh[..., half:], xh[..., :half]], dim=-1)
    return (xh * cos[None, :, None, :].to(x.dtype)
            + rot * sin[None, :, None, :].to(x.dtype)).reshape(B, S, H)


def _mm32(a, w):
    """a @ w in f32 from the operands' values (the kernels' f32
    accumulation)."""
    return a.float() @ w.float()


def _silu32(g):
    return g * torch.sigmoid(g)


def _fused_qkv_plain(x, ln, wq, wk, wv, sin, cos, D, eps):
    dt = x.dtype
    xn = _rms_norm(x, ln, eps)
    q = _rope_flat(_mm32(xn, wq).to(dt), sin, cos, D)
    k = _rope_flat(_mm32(xn, wk).to(dt), sin, cos, D)
    return q, k, _mm32(xn, wv).to(dt)


def _heads(t, D):
    B, S, H = t.shape
    return t.view(B, S, H // D, D)


def _fused_attn_epilogue_plain(q, k, v, x, wo, D):
    B, S, H = x.shape
    attn, lse = fa._flash_fwd_plain(_heads(q, D), _heads(k, D),
                                    _heads(v, D))
    attn = attn.reshape(B, S, H)
    y = (x.float() + _mm32(attn, wo)).to(x.dtype)
    return y, attn, lse


def _fused_mlp_fwd_plain(x, ln, wg, wu, wd, eps):
    xn = _rms_norm(x, ln, eps)
    a = (_silu32(_mm32(xn, wg)) * _mm32(xn, wu)).to(x.dtype)
    return (x.float() + _mm32(a, wd)).to(x.dtype)


def _fused_mlp_bwd_dx_plain(x, ln, wg, wu, wd, dy, eps):
    """pallas_ops.py:1444-1491 in f32: da = dy wd^T, dg and du in f32,
    dxn = dg wg^T + du wu^T, then the RMSNorm backward and the
    residual."""
    xn = _rms_norm(x, ln, eps)
    g, u = _mm32(xn, wg), _mm32(xn, wu)
    da = _mm32(dy, wd.t())
    sg = torch.sigmoid(g)
    dg = da * u * (sg + g * sg * (1.0 - sg))
    du = da * (g * sg)
    dacc = dg @ wg.float().t() + du @ wu.float().t()
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    dz = dacc * ln.float()
    inner = torch.sum(dz * x32, dim=-1, keepdim=True)
    dxn_x = dz * r - x32 * (inner * r * r * r / x.shape[-1])
    return (dy.float() + dxn_x).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels (CUDA tensors)
# ---------------------------------------------------------------------------

_ARGTYPES = {
    # x ln wq wk wv sin cos xn q k v M S H D eps stream
    "fused_qkv_launch": 11 * ["p"] + 4 * ["i"] + ["f", "p"],
    # attn wo x y M H stream
    "fused_attn_out_launch": 4 * ["p"] + 2 * ["i"] + ["p"],
    # x ln wg wu wd xn a y M H I eps stream
    "fused_mlp_fwd_launch": 8 * ["p"] + 3 * ["i"] + ["f", "p"],
    # x ln wg wu wd dy xn dgu dxn dx M H I eps stream
    "fused_mlp_bwd_dx_launch": 10 * ["p"] + 3 * ["i"] + ["f", "p"],
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _fn(name):
    fn = getattr(_build.load("fused_blocks"), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _check(what, x, named, aligned=True):
    """Raise on what the kernels do not take.  ``x`` is the [B, S, H]
    activation; ``named`` maps each other operand's name to (tensor,
    expected shape, expected dtype).  Pure shape/dtype checks, so the CPU
    tests reach them too; ``aligned=False`` (the fake registrations,
    whose tensors have no storage) skips the 16-byte alignment."""
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be [B, S, H], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16, got {x.dtype}")
    if x.shape[0] < 1 or x.shape[1] < 1 or x.shape[2] % _TILE:
        raise ValueError(f"{what} kernel needs B, S >= 1 and H a multiple "
                         f"of {_TILE}, got {tuple(x.shape)}")
    for name, (t, shape, dtype) in {"x": (x, tuple(x.shape), x.dtype),
                                    **named}.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
                or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {tuple(shape)} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _head_dim(what, H, D):
    if D not in _HEAD_DIMS or H % D:
        raise ValueError(f"{what} kernel takes head dim {_HEAD_DIMS} "
                         f"dividing H, got D={D}, H={H}")


def _inter(what, wg):
    I = wg.shape[-1]
    if I % _TILE or I < _TILE:
        raise ValueError(f"{what} kernel needs the intermediate size a "
                         f"multiple of {_TILE}, got {I}")
    return I


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _qkv_args(x, ln, wq, wk, wv, sin, cos, D, aligned=True):
    B, S, H = x.shape
    _head_dim("fused_qkv", H, D)
    bf, f32 = torch.bfloat16, torch.float32
    _check("fused_qkv", x, {"ln": (ln, (H,), bf), "wq": (wq, (H, H), bf),
                            "wk": (wk, (H, H), bf), "wv": (wv, (H, H), bf),
                            "sin": (sin, (S, D), f32),
                            "cos": (cos, (S, D), f32)}, aligned)
    return B, S, H


def _fused_qkv_cuda(x, ln, wq, wk, wv, sin, cos, D, eps):
    B, S, H = _qkv_args(x, ln, wq, wk, wv, sin, cos, D)
    xn = _empty((B * S, H), torch.bfloat16, x)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    err = _fn("fused_qkv_launch")(
        x.data_ptr(), ln.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), sin.data_ptr(), cos.data_ptr(), xn.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B * S, S, H, D, eps,
        _build.stream_ptr(x.device))
    _build.check(err, "fused_qkv")
    fused_qkv.launches += 1
    return q, k, v


def _epi_args(q, k, v, x, wo, D, aligned=True):
    B, S, H = x.shape
    _head_dim("fused_attn_epilogue", H, D)
    bf = torch.bfloat16
    _check("fused_attn_epilogue", x, {
        "q": (q, (B, S, H), bf), "k": (k, (B, S, H), bf),
        "v": (v, (B, S, H), bf), "wo": (wo, (H, H), bf)}, aligned)
    return B, S, H


def _fused_attn_epilogue_cuda(q, k, v, x, wo, D):
    B, S, H = _epi_args(q, k, v, x, wo, D)
    attn, lse = fa._launch_fwd(_heads(q, D), _heads(k, D), _heads(v, D))
    attn = attn.view(B, S, H)
    y = torch.empty_like(x)
    err = _fn("fused_attn_out_launch")(
        attn.data_ptr(), wo.data_ptr(), x.data_ptr(), y.data_ptr(), B * S, H,
        _build.stream_ptr(x.device))
    _build.check(err, "fused_attn_epilogue")
    fused_attn_epilogue.launches += 1
    return y, attn, lse


def _mlp_args(what, x, ln, wg, wu, wd, extra=None, aligned=True):
    H = x.shape[-1]
    I = _inter(what, wg)
    bf = torch.bfloat16
    _check(what, x, {"ln": (ln, (H,), bf), "w_gate": (wg, (H, I), bf),
                     "w_up": (wu, (H, I), bf), "w_down": (wd, (I, H), bf),
                     **(extra or {})}, aligned)
    return x.shape[0] * x.shape[1], H, I


def _fused_mlp_fwd_cuda(x, ln, wg, wu, wd, eps):
    M, H, I = _mlp_args("fused_mlp_fwd", x, ln, wg, wu, wd)
    xn = _empty((M, H), torch.bfloat16, x)
    a = _empty((M, I), torch.bfloat16, x)
    y = torch.empty_like(x)
    err = _fn("fused_mlp_fwd_launch")(
        x.data_ptr(), ln.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), xn.data_ptr(), a.data_ptr(), y.data_ptr(), M, H, I,
        eps, _build.stream_ptr(x.device))
    _build.check(err, "fused_mlp_fwd")
    fused_mlp_fwd.launches += 1
    return y


def _fused_mlp_bwd_dx_cuda(x, ln, wg, wu, wd, dy, eps):
    M, H, I = _mlp_args("fused_mlp_bwd_dx", x, ln, wg, wu, wd,
                        {"dy": (dy, tuple(x.shape), torch.bfloat16)})
    xn = _empty((M, H), torch.bfloat16, x)
    dgu = _empty((M, 2 * I), torch.bfloat16, x)
    dxn = _empty((M, H), torch.float32, x)
    dx = torch.empty_like(x)
    err = _fn("fused_mlp_bwd_dx_launch")(
        x.data_ptr(), ln.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), dy.data_ptr(), xn.data_ptr(), dgu.data_ptr(),
        dxn.data_ptr(), dx.data_ptr(), M, H, I, eps,
        _build.stream_ptr(x.device))
    _build.check(err, "fused_mlp_bwd_dx")
    fused_mlp_bwd_dx.launches += 1
    return dx


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def _on_card(x, what):
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: no kernel for device {x.device}")


# The three forward wrappers run through ``torch.library`` custom ops:
# the CUDA registration launches the kernel (the ``_*_cuda`` functions,
# which count), the CPU one is the plain version, and the fake one gives
# the outputs' shapes (after the kernels' own checks on CUDA tensors), so
# a ``jit`` capture records one node a call and its replay launches the
# kernel.  Every pointer use, check and workspace stays inside the CUDA
# registration.  ``fused_mlp_bwd_dx`` runs only in a backward and stays
# a plain call.

_T = torch.Tensor


def _fresh(*ts):
    return tuple(t.contiguous() for t in ts)


@torch.library.custom_op("paddle_tpu_torch::fused_qkv", mutates_args=())
def _fused_qkv_op(x: _T, ln: _T, wq: _T, wk: _T, wv: _T, sin: _T, cos: _T,
                  head_dim: int, eps: float) -> tuple[_T, _T, _T]:
    return _fresh(*_fused_qkv_plain(x, ln, wq, wk, wv, sin, cos, head_dim,
                                    eps))


_fused_qkv_op.register_kernel("cuda")(
    lambda *a: _fused_qkv_cuda(*a))


@_fused_qkv_op.register_fake
def _fused_qkv_fake(x, ln, wq, wk, wv, sin, cos, head_dim, eps):
    if x.device.type == "cuda":
        _qkv_args(x, ln, wq, wk, wv, sin, cos, head_dim, aligned=False)
    shape = x.shape[:-1] + (wq.shape[-1],)
    return tuple(x.new_empty(shape) for _ in range(3))


@torch.library.custom_op("paddle_tpu_torch::fused_attn_epilogue",
                         mutates_args=())
def _fused_attn_epilogue_op(q: _T, k: _T, v: _T, x: _T, wo: _T,
                            head_dim: int) -> tuple[_T, _T, _T]:
    return _fresh(*_fused_attn_epilogue_plain(q, k, v, x, wo, head_dim))


_fused_attn_epilogue_op.register_kernel("cuda")(
    lambda *a: _fused_attn_epilogue_cuda(*a))


@_fused_attn_epilogue_op.register_fake
def _fused_attn_epilogue_fake(q, k, v, x, wo, head_dim):
    B, S, H = x.shape
    if x.device.type == "cuda":
        _epi_args(q, k, v, x, wo, head_dim, aligned=False)
    return (x.new_empty(x.shape), q.new_empty(q.shape),
            x.new_empty((B, H // head_dim, S), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::fused_mlp_fwd", mutates_args=())
def _fused_mlp_fwd_op(x: _T, ln: _T, wg: _T, wu: _T, wd: _T,
                      eps: float) -> _T:
    return _fresh(_fused_mlp_fwd_plain(x, ln, wg, wu, wd, eps))[0]


_fused_mlp_fwd_op.register_kernel("cuda")(
    lambda *a: _fused_mlp_fwd_cuda(*a))


@_fused_mlp_fwd_op.register_fake
def _fused_mlp_fwd_fake(x, ln, wg, wu, wd, eps):
    if x.device.type == "cuda":
        _mlp_args("fused_mlp_fwd", x, ln, wg, wu, wd, aligned=False)
    return x.new_empty(x.shape)


def fused_qkv(x, ln, wq, wk, wv, sin, cos, *, head_dim, eps=1e-6):
    """x [B, S, H] -> (q, k, v) [B, S, H]: RMSNorm, projections, rope on
    q and k."""
    _on_card(x, "fused_qkv")
    return _numerics.opaque("fused_qkv", _fused_qkv_op, x, ln, wq, wk, wv,
                            sin, cos, int(head_dim), float(eps))


def fused_attn_epilogue(q, k, v, x, wo, *, head_dim):
    """Causal attention over the flat heads and ``y = x + attn wo``:
    (y, attn [B, S, H], lse [B, nh, S] f32)."""
    _on_card(x, "fused_attn_epilogue")
    return _numerics.opaque("fused_attn_epilogue", _fused_attn_epilogue_op,
                            q, k, v, x, wo, int(head_dim))


def fused_mlp_fwd(x, ln, wg, wu, wd, *, eps=1e-6):
    """y = x + (silu(rms(x) wg) * (rms(x) wu)) wd."""
    _on_card(x, "fused_mlp_fwd")
    return _numerics.opaque("fused_mlp_fwd", _fused_mlp_fwd_op, x, ln, wg,
                            wu, wd, float(eps))


def fused_mlp_bwd_dx(x, ln, wg, wu, wd, dy, *, eps=1e-6):
    """dx of the MLP block (residual included) for the output gradient
    dy."""
    fn = (_fused_mlp_bwd_dx_cuda if _on_card(x, "fused_mlp_bwd_dx")
          else _fused_mlp_bwd_dx_plain)
    return _numerics.opaque("fused_mlp_bwd_dx", fn, x, ln, wg, wu, wd, dy,
                            eps)


fused_qkv.launches = 0            # kernel launches since last reset
fused_attn_epilogue.launches = 0
fused_mlp_fwd.launches = 0
fused_mlp_bwd_dx.launches = 0


# ---------------------------------------------------------------------------
# the blocks, differentiable
# ---------------------------------------------------------------------------

def _leaf(t):
    return t.detach().requires_grad_(True)


class _FusedAttention(torch.autograd.Function):
    """``_fused_attention_call``'s custom VJP (pallas_ops.py:1343-1386)."""

    @staticmethod
    def forward(ctx, x, ln, wq, wk, wv, wo, sin, cos, head_dim, eps):
        q, k, v = fused_qkv(x, ln, wq, wk, wv, sin, cos, head_dim=head_dim,
                            eps=eps)
        y, attn, lse = fused_attn_epilogue(q, k, v, x, wo,
                                           head_dim=head_dim)
        ctx.save_for_backward(x, ln, wq, wk, wv, wo, sin, cos, q, k, v,
                              attn, lse)
        ctx.cfg = (head_dim, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, ln, wq, wk, wv, wo, sin, cos, q, k, v, attn, lse = \
            ctx.saved_tensors
        D, eps = ctx.cfg
        H = x.shape[-1]
        dy = dy.contiguous()
        # the epilogue's transpose
        dwo = attn.reshape(-1, H).t() @ dy.reshape(-1, H)
        gb = dy @ wo.t()
        # the O(S^2) core: the flash backward on [B, S, nh, D]
        qh, kh, vh, oh, gh = (_heads(t, D) for t in (q, k, v, attn, gb))
        dq, dk, dv = fa.flash_bwd(qh, kh, vh, oh, lse, gh)
        # the prologue's transpose: autograd of its plain composition
        with torch.enable_grad():
            xl, lnl, wql, wkl, wvl = (_leaf(t) for t in (x, ln, wq, wk, wv))
            xn = _rms_norm(xl, lnl, eps)
            outs = (_rope_flat(xn @ wql, sin, cos, D),
                    _rope_flat(xn @ wkl, sin, cos, D), xn @ wvl)
            dx_p, dln, dwq, dwk, dwv = torch.autograd.grad(
                outs, (xl, lnl, wql, wkl, wvl),
                tuple(t.reshape(x.shape) for t in (dq, dk, dv)))
        return (dy + dx_p, dln, dwq, dwk, dwv, dwo, None, None, None, None)


class _FusedMLP(torch.autograd.Function):
    """``_fused_mlp_call``'s custom VJP (pallas_ops.py:1521-1561): saves
    the inputs only."""

    @staticmethod
    def forward(ctx, x, ln, wg, wu, wd, eps):
        ctx.save_for_backward(x, ln, wg, wu, wd)
        ctx.eps = eps
        return fused_mlp_fwd(x, ln, wg, wu, wd, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln, wg, wu, wd = ctx.saved_tensors
        dy = dy.contiguous()
        dx = fused_mlp_bwd_dx(x, ln, wg, wu, wd, dy, eps=ctx.eps)
        # ln and weight gradients: autograd of the plain composition with
        # x fixed
        with torch.enable_grad():
            lnl, wgl, wul, wdl = (_leaf(t) for t in (ln, wg, wu, wd))
            xn = _rms_norm(x, lnl, ctx.eps)
            out = (F.silu(xn @ wgl) * (xn @ wul)) @ wdl
            dln, dwg, dwu, dwd = torch.autograd.grad(
                out, (lnl, wgl, wul, wdl), dy)
        return dx, dln, dwg, dwu, dwd, None


def fused_attention_block(x, ln, wq, wk, wv, wo, sin, cos, *, head_dim,
                          eps=1e-6):
    """``x + attn(rope(rms(x) wq), rope(rms(x) wk), rms(x) wv) wo``,
    differentiable in x, ln and the four weights."""
    return _FusedAttention.apply(x, ln, wq, wk, wv, wo, sin, cos,
                                 head_dim, float(eps))


def fused_mlp_block(x, ln, w_gate, w_up, w_down, *, eps=1e-6):
    """``x + (silu(rms(x) w_gate) * (rms(x) w_up)) w_down``,
    differentiable in x, ln and the three weights."""
    return _FusedMLP.apply(x, ln, w_gate, w_up, w_down, float(eps))


def fused_attention_ok(hidden, head_dim):
    """Shapes the fused attention kernels take (any device)."""
    return head_dim in _HEAD_DIMS and hidden % _TILE == 0 \
        and hidden % head_dim == 0


def fused_mlp_ok(hidden, inter):
    """Shapes the fused MLP kernels take (any device)."""
    return hidden % _TILE == 0 and inter % _TILE == 0 and inter > 0
