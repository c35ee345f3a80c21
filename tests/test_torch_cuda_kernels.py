"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA card with nvcc (they build the kernels
from ``paddle_tpu_torch/ops/csrc``) and skips without one; card presence
is decided in the ``cuda`` fixture, never at import.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: the int8 matmul is bit-identical to its plain version (the
same f32 operations in the same order).  Attention differs from its
plain version only in summation order: atol 1e-5 in float32 and 2e-2
in bfloat16 (8 mantissa bits on outputs of magnitude ~1); padding rows
are exact zeros in both.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import int8_matmul as i8
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [
    (1, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (9, 4096, 32000),
    (64, 4096, 4096), (3, 72, 200), (130, 256, 36),
])
def test_int8_matmul_kernel_is_bit_identical(cuda, M, K, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    x[0] = 0                                   # all-zero row: eps floor
    w = torch.randn((K, N), generator=g, device=cuda) * 0.02
    wq, ws = i8.quantize_int8(w)
    before = i8.int8_matmul.launches
    y = i8.int8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert i8.int8_matmul.launches == before + 1
    ref = i8._int8_matmul_plain(x, wq, ws)
    assert y.dtype == dtype and y.shape == (M, N)
    assert torch.equal(y, ref)


def _rpa_case(device, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens,
              dtype, seed):
    rng = np.random.RandomState(seed)
    Tr = Tc * rep
    q = torch.from_numpy(rng.standard_normal((R, nkv, Tr, d))
                         .astype(np.float32)).to(device, dtype)
    kp = torch.from_numpy(rng.standard_normal((nkv, P, page, d))
                          .astype(np.float32)).to(device, dtype)
    vp = torch.from_numpy(rng.standard_normal((nkv, P, page, d))
                          .astype(np.float32)).to(device, dtype)
    tbl = (1 + rng.permutation(P - 1)[:R * Bmax]).reshape(R, Bmax)
    tbl = torch.from_numpy(tbl.astype(np.int32)).to(device)
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    qlens = torch.tensor(qlens, dtype=torch.int32, device=device)
    return q, kp, vp, tbl, lens, qlens


RPA_CASES = [
    # (R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens)
    (8, 32, 1, 8, 128, 40, 16, 4, [8, 20, 0, 33, 1, 16, 64, 9],
     [8, 4, 0, 8, 1, 3, 8, 2]),
    (8, 32, 1, 1, 128, 40, 16, 4, [1, 17, 33, 64, 0, 9, 2, 50],
     [1, 1, 1, 1, 0, 1, 1, 1]),
    (4, 8, 4, 8, 128, 24, 16, 4, [40, 9, 0, 64], [8, 2, 0, 5]),
    (3, 2, 2, 4, 64, 16, 8, 4, [30, 5, 12], [4, 1, 3]),
    (2, 2, 1, 20, 128, 12, 24, 3, [70, 20], [20, 19]),  # page 24, 2 tiles
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", RPA_CASES)
def test_ragged_attention_kernel_matches_plain(cuda, case, dtype, atol):
    R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args = _rpa_case(cuda, *case, dtype=dtype, seed=R + P)
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(*args, rep=rep)
    torch.cuda.synchronize()
    assert rpa.ragged_paged_attention.launches == before + 1
    ref = rpa._ragged_attention_plain(*args, rep)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= atol
    tok = torch.arange(Tc * rep, device=cuda) // rep
    pad = tok[None, :] >= args[5][:, None]
    assert not out.float()[pad[:, None, :, None].expand_as(out)].any()


def test_ragged_attention_kernel_refuses_what_it_cannot_serve(cuda):
    args = _rpa_case(cuda, 1, 1, 1, 1, 128, 4, 12, 1, [3], [1],
                     torch.float32, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        rpa.ragged_paged_attention(*args)
    args = _rpa_case(cuda, 1, 1, 1, 1, 96, 4, 16, 1, [3], [1],
                     torch.float32, 0)
    with pytest.raises(ValueError, match="head dim"):
        rpa.ragged_paged_attention(*args)


def test_forward_paged_on_the_card_matches_the_cpu(cuda):
    """A small model, float32, int8 weights, one mixed prefill + decode
    step: the card (both kernels) against the CPU (plain versions).  The
    logits and the written pools agree to float32 summation order except
    where an activation lands within an ulp of a rounding boundary of its
    int8 quantization on one side only; each such flip moves an output
    by at most x_scale * max|w| (~3e-3 here), hence atol 1e-2."""
    cfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, quantized="on")
    params = tllama.quantize_params(
        cfg, tllama.init_params(cfg, 0, device="cpu"))
    rng = np.random.RandomState(0)
    R, Tc, P, page, Bmax = 4, 8, 16, 16, 3
    shape = (2, 1, P, page, 128)
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                           .reshape(R, Bmax).astype(np.int32))
    lens = torch.tensor([8, 21, 0, 40], dtype=torch.int32)
    qlens = torch.tensor([8, 1, 0, 6], dtype=torch.int32)
    tokens = torch.from_numpy(rng.randint(0, 512, (R, Tc)).astype(np.int32))
    outs = []
    for dev in ("cpu", cuda):
        p_dev = convert.params_to(params, dev)
        k_dev, v_dev = kp.clone().to(dev), vp.clone().to(dev)
        before = i8.int8_matmul.launches
        logits, _ = tllama.forward_paged(
            cfg, p_dev, tokens.to(dev), k_dev, v_dev, tbl.to(dev),
            lens.to(dev), qlens.to(dev))
        if dev != "cpu":
            assert i8.int8_matmul.launches == before + 7 * 2 + 1
        outs.append((logits.cpu(), k_dev.cpu(), v_dev.cpu()))
    for r, q in enumerate(qlens.tolist()):
        if q:    # rows past q_len (and empty slots) are garbage by contract
            diff = (outs[0][0][r, :q] - outs[1][0][r, :q]).abs().max()
            assert diff.item() <= 1e-2, (r, diff)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert (a[:, :, 1:] - b[:, :, 1:]).abs().max().item() <= 1e-2


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
# The kernels take bf16 and feed bf16 p and ds to the tensor cores; the
# plain version runs in f32 on the same bf16 inputs.  Tolerances: output
# max |diff| <= 2e-2 (bf16 output of magnitude ~1), lse <= 1e-3 (f32),
# gradients max |diff| / max(max |ref|, 1e-3) <= 2e-2.  The floor is for
# S = 1: a row's softmax then has one key, so dq and dk are exactly 0
# and both sides hold rounding noise of ~1e-7.  Each row of o, dq, dk and
# dv is also held to its own scale: RMS error over the row's RMS
# (floored at 1e-3) <= 2e-2, since at S = 2048 a late row of o is ~20x
# smaller than an early one and a max-based limit cannot see it.

from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _qkvd(device, B, S, H, D, seed, Hkv=None):
    rng = np.random.RandomState(seed)
    Hkv = Hkv or H
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device, torch.bfloat16) for s in shapes]


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-3)).item()


def _row_rel(got, ref):
    d, r = got.float() - ref.float(), ref.float()
    return (d.pow(2).mean(-1).sqrt()
            / r.pow(2).mean(-1).sqrt().clamp_min(1e-3)).max().item()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 17, 128, 2048])
def test_flash_kernels_match_plain(cuda, S, D):
    B, H = (2, 3) if S < 2048 else (1, 2)
    q, k, v, do = _qkvd(cuda, B, S, H, D, seed=S + D)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa._flash_fwd_plain(*f[:3])
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert _row_rel(o, o_ref) <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    dq_ref, delta_ref = fa._flash_bwd_dq_plain(*f[:3], o.float(), lse, f[3])
    dk_ref, dv_ref = fa._flash_bwd_dkv_plain(*f[:3], f[3], lse, delta_ref)
    assert (delta - delta_ref).abs().max().item() <= 1e-3 * max(
        1.0, delta_ref.abs().max().item())
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel(got, ref) <= 2e-2
        assert _row_rel(got, ref) <= 2e-2


def test_causal_attention_autograd_gqa_on_card(cuda):
    """GQA as models.llama._attention feeds it: kv heads repeated with
    repeat_interleave, gradients summed back through the repeat."""
    B, S, H, Hkv, D = 2, 300, 4, 2, 128
    q, k, v, do = _qkvd(cuda, B, S, H, D, seed=7, Hkv=Hkv)

    def run(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = fa.causal_attention(q, k.repeat_interleave(H // Hkv, dim=2),
                                  v.repeat_interleave(H // Hkv, dim=2))
        out.backward(do.to(out.device, out.dtype))
        return out, q.grad, k.grad, v.grad

    got = run(q, k, v)
    ref = run(*(t.float().cpu() for t in (q, k, v)))
    assert (got[0].float().cpu() - ref[0]).abs().max().item() <= 2e-2
    for g, r in zip(got[1:], ref[1:]):
        assert _rel(g.cpu(), r) <= 2e-2


def test_attention_layer_on_card_matches_cpu(cuda):
    """models.llama._attention (GQA, rope, projections) in bf16 on the
    card against f32 on the CPU, on the same bf16 weights.  The bf16
    projections round too, so the gradients get 5e-2 of their max."""
    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=256,
                             intermediate_size=256, num_hidden_layers=1,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=128,
                             dtype=torch.bfloat16)
    params = tllama.init_params(cfg, 0, device="cpu")
    lp = {n: params["layers"][n][0] for n in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (2, 96, 256)).astype(np.float32)).to(torch.bfloat16)
    outs = []
    for dev, dtype in (("cpu", torch.float32), (cuda, torch.bfloat16)):
        w = {n: t.to(dev, dtype).requires_grad_() for n, t in lp.items()}
        xx = x.to(dev, dtype).requires_grad_()
        sin, cos = tllama._rope_tables(cfg, 96, xx.device)
        out = tllama._attention(cfg, w, xx, sin, cos)
        out.float().square().sum().backward()
        outs.append((out.float().cpu(), xx.grad.float().cpu(),
                     *(w[n].grad.float().cpu() for n in lp)))
    assert (outs[0][0] - outs[1][0]).abs().max().item() <= 2e-2
    for r, g in zip(outs[0][1:], outs[1][1:]):
        assert _rel(g, r) <= 5e-2


def test_flash_kernels_refuse_what_they_cannot_serve(cuda):
    q, k, v, _ = _qkvd(cuda, 1, 16, 2, 64, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    q, k, v, _ = _qkvd(cuda, 1, 16, 2, 96, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, k, v)


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_train_step_launches_the_flash_kernels(cuda, policy):
    """A small bf16 train step on the card with the unfused layer
    (``fused_blocks="off"``): every layer's attention goes through the
    kernels, the forward twice under remat (recomputed in the backward),
    and the gradients are finite."""
    cfg = tllama.LlamaConfig(vocab_size=128, hidden_size=256,
                             intermediate_size=256, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=64,
                             use_remat=policy != "none",
                             remat_policy="full" if policy == "none"
                             else policy, fused_blocks="off")
    params = tllama.init_params(cfg, 0, device=cuda)
    leaves = [params["embed"], params["lm_head"], params["norm_f"],
              *params["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.randint(0, 128, (2, 64), device=cuda)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    total, ce = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                             "labels": ids})
    total.backward()
    torch.cuda.synchronize()
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
             fa.flash_bwd_dkv.launches)
    fwd = 2 if policy == "none" else 4
    assert tuple(a - b for a, b in zip(after, before)) == (fwd, 2, 2)
    assert torch.isfinite(ce)
    assert all(torch.isfinite(t.grad).all() for t in leaves)


# ---------------------------------------------------------------------------
# the fused decoder blocks
# ---------------------------------------------------------------------------
# The kernels take bf16 and their plain versions run on the same bf16
# inputs with the kernels' rounding (products in f32, casts where the
# kernels cast), so the two differ by f32 summation order, which flips an
# occasional bf16 rounding, and, in dx, by the bf16 rounding of the f32
# dg, du that feed the tensor cores.  Each output is held per row: RMS
# error over the row's RMS <= 2e-2, and max |diff| <= 2e-2 * max |ref|.

from paddle_tpu_torch.ops import fused_blocks as fb  # noqa: E402

FUSED_CASES = [
    # (B, S, H, D, I): S = 200 and 77 are not multiples of the 128-row
    # tile; the last is the bench's width at a short S
    (1, 200, 256, 128, 512), (2, 77, 256, 64, 512), (1, 200, 2048, 128, 5632),
]


def _fused_inputs(device, B, S, H, D, I, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            torch.bfloat16)

    half = D // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, device=device).float()
                             / half))
    ang = torch.arange(S, device=device).float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    return dict(x=rnd(B, S, H), dy=rnd(B, S, H),
                ln=(1 + 0.1 * torch.randn(H, generator=g, device=device)).to(
                    torch.bfloat16),
                w=[rnd(H, H, scale=0.02) for _ in range(4)],
                wg=rnd(H, I, scale=0.02), wu=rnd(H, I, scale=0.02),
                wd=rnd(I, H, scale=0.02), sin=emb.sin(), cos=emb.cos())


def _held(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert _row_rel(got, ref) <= 2e-2
    assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_kernels_match_plain(cuda, case):
    B, S, H, D, I = case
    t = _fused_inputs(cuda, *case, seed=S + H)
    wq, wk, wv, wo = t["w"]
    before = (fb.fused_qkv.launches, fb.fused_attn_epilogue.launches,
              fb.fused_mlp_fwd.launches, fb.fused_mlp_bwd_dx.launches)
    q, k, v = fb.fused_qkv(t["x"], t["ln"], wq, wk, wv, t["sin"], t["cos"],
                           head_dim=D)
    y, attn, lse = fb.fused_attn_epilogue(q, k, v, t["x"], wo, head_dim=D)
    ym = fb.fused_mlp_fwd(t["x"], t["ln"], t["wg"], t["wu"], t["wd"])
    dx = fb.fused_mlp_bwd_dx(t["x"], t["ln"], t["wg"], t["wu"], t["wd"],
                             t["dy"])
    torch.cuda.synchronize()
    after = (fb.fused_qkv.launches, fb.fused_attn_epilogue.launches,
             fb.fused_mlp_fwd.launches, fb.fused_mlp_bwd_dx.launches)
    assert after == tuple(c + 1 for c in before)
    ref = fb._fused_qkv_plain(t["x"], t["ln"], wq, wk, wv, t["sin"],
                              t["cos"], D, 1e-6)
    for got, r in zip((q, k, v), ref):
        _held(got, r)
    y_r, attn_r, lse_r = fb._fused_attn_epilogue_plain(q, k, v, t["x"], wo,
                                                       D)
    _held(y, y_r)
    _held(attn, attn_r)
    assert lse.shape == (B, H // D, S)
    assert (lse - lse_r).abs().max().item() <= 1e-3
    _held(ym, fb._fused_mlp_fwd_plain(t["x"], t["ln"], t["wg"], t["wu"],
                                      t["wd"], 1e-6))
    _held(dx, fb._fused_mlp_bwd_dx_plain(t["x"], t["ln"], t["wg"], t["wu"],
                                         t["wd"], t["dy"], 1e-6))


def test_fused_kernels_refuse_what_they_cannot_serve(cuda):
    t = _fused_inputs(cuda, 1, 16, 256, 128, 512, seed=0)
    x, ln, wg, wu, wd = t["x"], t["ln"], t["wg"], t["wu"], t["wd"]
    with pytest.raises(TypeError, match="bfloat16"):
        fb.fused_mlp_fwd(x.float(), ln.float(), wg.float(), wu.float(),
                         wd.float())
    with pytest.raises(ValueError, match="w_down"):
        fb.fused_mlp_fwd(x, ln, wg, wu, wd[:, :128])
    with pytest.raises(ValueError, match="not contiguous"):
        fb.fused_mlp_bwd_dx(x, ln, wg, wu, wd,
                            torch.cat([x, x], -1)[..., ::2])
    with pytest.raises(ValueError, match="multiple of 128"):
        fb.fused_mlp_fwd(x, ln, wg[:, :200], wu[:, :200], wd[:200])
    wq, wk, wv, wo = t["w"]
    with pytest.raises(ValueError, match="head dim"):
        fb.fused_qkv(x, ln, wq, wk, wv, t["sin"], t["cos"], head_dim=32)
    with pytest.raises(ValueError, match="wo"):
        fb.fused_attn_epilogue(x, x, x, x, wo.t(), head_dim=128)


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_train_step_launches_the_fused_kernels(cuda, policy):
    """A small bf16 train step on the card at the default policy: both
    fused blocks engage (nkv == nh, head dim 128), each forward kernel
    runs once per layer and again under remat, dx once per layer, the
    flash backward once per layer and the flash forward not at all."""
    cfg = tllama.LlamaConfig(vocab_size=128, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=64,
                             use_remat=policy != "none", remat_policy="dots")
    params = tllama.init_params(cfg, 0, device=cuda)
    leaves = [params["embed"], params["lm_head"], params["norm_f"],
              *params["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.randint(0, 128, (2, 64), device=cuda)
    wrappers = (fb.fused_qkv, fb.fused_attn_epilogue, fb.fused_mlp_fwd,
                fb.fused_mlp_bwd_dx, fa.flash_fwd, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    total, ce = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                             "labels": ids})
    total.backward()
    torch.cuda.synchronize()
    fwd = 2 if policy == "none" else 4
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        fwd, fwd, fwd, 2, 0, 2, 2]
    assert torch.isfinite(ce)
    assert all(torch.isfinite(t.grad).all() for t in leaves)
