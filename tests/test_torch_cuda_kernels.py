"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA card with nvcc (they build the kernels
from ``paddle_tpu_torch/ops/csrc``) and skips without one; card presence
is decided in the ``cuda`` fixture, never at import.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: the int8 matmul is bit-identical to its plain version (the
same f32 operations in the same order).  Attention differs from its
plain version only in summation order: atol 1e-5 in float32 (2e-5 over
int8 pages, whose dequantized values reach ~4) and 2e-2 in bfloat16 (8
mantissa bits on outputs of magnitude ~1); padding rows are exact zeros
in both.
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


def _int8_case(device, M, K, N, dtype):
    g = torch.Generator(device=device).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=device).to(dtype)
    x[0] = 0                                   # all-zero row: eps floor
    w = torch.randn((K, N), generator=g, device=device) * 0.02
    wq, ws = i8.quantize_int8(w)
    return x, wq, ws


# every llama7b shape at M = 8 (decode, the stream regime), 64 and 512
# (prefill chunks, the rows regime); both sides of the regime threshold
# (8 | 9) and of the stream tile (16 | 17); M = 200, no multiple of a row
# tile; K, N off the 16-byte copies and the tiles
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [
    (1, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (9, 4096, 32000),
    (64, 4096, 4096), (3, 72, 200), (130, 256, 36),
    (16, 4096, 4096), (17, 4096, 4096), (200, 1024, 4096),
    (512, 4096, 11008), (512, 11008, 4096), (512, 4096, 32000),
    (8, 4096, 4096), (8, 4096, 32000), (64, 4096, 11008), (64, 11008, 4096),
    (64, 4096, 32000), (512, 4096, 4096),
])
def test_int8_matmul_kernel_is_bit_identical(cuda, M, K, N, dtype):
    x, wq, ws = _int8_case(cuda, M, K, N, dtype)
    before = i8.int8_matmul.launches
    y = i8.int8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert i8.int8_matmul.launches == before + 1
    ref = i8._int8_matmul_plain(x, wq, ws)
    assert y.dtype == dtype and y.shape == (M, N)
    assert torch.equal(y, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [8, 16, 200])
def test_int8_matmul_kernel_saturates_outlier_rows(cuda, M, dtype):
    """One large outlier a row (positive in row 1, negative in row 2):
    it quantizes to +-127 and the row's other values to a few levels."""
    x, wq, ws = _int8_case(cuda, M, 4096, 4096, dtype)
    x[1, 7] = 3000.0
    x[2, 4000] = -3000.0
    y = i8.int8_matmul(x, wq, ws)
    xq, _ = i8._quantize_rows(x.float())
    assert xq[1, 7].item() == 127 and xq[2, 4000].item() == -127
    assert torch.equal(y, i8._int8_matmul_plain(x, wq, ws))


@pytest.mark.parametrize("M", [1, 8, 16])
def test_int8_matmul_both_regimes_agree_below_the_threshold(cuda, M):
    """Rows the stream regime can serve (M <= 16), run through both
    regimes (``stream_rows`` 16 and 0): both bit-identical to the plain
    version."""
    x, wq, ws = _int8_case(cuda, M, 4096, 11008, torch.bfloat16)
    ref = i8._int8_matmul_plain(x, wq, ws)
    for rows in (16, 0):
        assert i8._plan_for(x, wq, rows).launches == (1 if rows else 2)
        y = i8._int8_matmul_cuda(x, wq, ws, stream_rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), f"stream_rows={rows}"


def test_int8_matmul_replays_in_a_cuda_graph(cuda):
    """A captured call replays with new inputs: no state carries over
    between calls (the split sums stay in the cluster's shared memory)."""
    for M, K, N in ((8, 4096, 4096), (64, 4096, 4096), (512, 4096, 4096)):
        x, wq, ws = _int8_case(cuda, M, K, N, torch.bfloat16)
        i8.int8_matmul(x, wq, ws)      # build and warm up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = i8.int8_matmul(x, wq, ws)
        for seed in (1, 2):
            g = torch.Generator(device=cuda).manual_seed(seed)
            x.copy_(torch.randn(x.shape, generator=g, device=cuda))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, i8._int8_matmul_plain(x, wq, ws))


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


# the long cases of chip_smoke.py's rpa_phase: load balance and split
# edges (ragged lengths off a page boundary, an empty slot), GQA at 2048
# tokens, and the long-context cell's chunk-64 prefill steps
LONG_CASES = [
    (8, 32, 1, 1, 128, 1025, 16, 128, [2048, 1, 700, 0, 1500, 33, 2047, 16],
     [1, 1, 1, 0, 1, 1, 1, 1]),
    (8, 8, 4, 1, 128, 1025, 16, 128, [2048] * 8, [1] * 8),
    (8, 32, 1, 64, 128, 545, 16, 68, [1024, 64, 577, 0, 1000, 130, 900, 1088],
     [64, 64, 64, 0, 1, 64, 1, 64]),
]

RPA_CASES = [
    # (R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens)
    (8, 32, 1, 8, 128, 40, 16, 4, [8, 20, 0, 33, 1, 16, 64, 9],
     [8, 4, 0, 8, 1, 3, 8, 2]),
    (8, 32, 1, 1, 128, 40, 16, 4, [1, 17, 33, 64, 0, 9, 2, 50],
     [1, 1, 1, 1, 0, 1, 1, 1]),
    (4, 8, 4, 8, 128, 24, 16, 4, [40, 9, 0, 64], [8, 2, 0, 5]),
    (3, 2, 2, 4, 64, 16, 8, 4, [30, 5, 12], [4, 1, 3]),
    (2, 2, 1, 20, 128, 12, 24, 3, [70, 20], [20, 19]),  # page 24, 2 tiles
] + [
    # llama7b width at 2048 tokens a request: the long decode, the same
    # with ragged lengths, GQA, and chunk-64 prefill with decode rows
    (8, 32, 1, 1, 128, 1025, 16, 128, [2048] * 8, [1] * 8),
] + LONG_CASES


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
# ragged paged attention over int8 pools (the kernel replacing
# _rpa_kernel_quant).  Against its plain version on the same int8 pages
# and scales: float32 q to 2e-5 (summation order, outputs of magnitude
# ~1), bfloat16 q to 2e-2 and each row within 2e-2 of its RMS; padding
# rows exact zeros.
# ---------------------------------------------------------------------------

def _rpa_quant_case(device, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens,
                    dtype, seed):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.standard_normal((R, nkv, Tc * rep, d))
                         .astype(np.float32)).to(device, dtype)
    tbl = (1 + rng.permutation(P - 1)[:R * Bmax]).reshape(R, Bmax)
    tbl = torch.from_numpy(tbl.astype(np.int32)).to(device)
    kp, vp = (torch.from_numpy(rng.randint(-127, 128, (nkv, P, page, d))
                               .astype(np.int8)).to(device)
              for _ in range(2))
    ksc, vsc = (torch.from_numpy(rng.uniform(0.005, 0.03, (nkv, P))
                                 .astype(np.float32)).to(device)
                for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    qlens = torch.tensor(qlens, dtype=torch.int32, device=device)
    return (q, kp, vp, tbl, lens, qlens), (ksc, vsc)


RPA_QUANT_CASES = [
    # (R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens)
    (8, 32, 1, 8, 128, 40, 16, 4, [8, 20, 0, 33, 1, 16, 64, 9],
     [8, 4, 0, 8, 1, 3, 8, 2]),
    (8, 32, 1, 1, 128, 40, 16, 4, [1, 17, 33, 64, 0, 9, 2, 50],
     [1, 1, 1, 1, 0, 1, 1, 1]),
    (4, 8, 4, 8, 128, 24, 16, 4, [40, 9, 0, 64], [8, 2, 0, 5]),   # GQA
    (3, 2, 2, 4, 64, 16, 8, 4, [30, 5, 12], [4, 1, 3]),           # page 8
    (3, 4, 1, 8, 64, 16, 32, 3, [90, 0, 40], [8, 0, 8]),          # page 32
    (4, 2, 1, 4, 128, 12, 16, 2, [0, 0, 0, 0], [0, 0, 0, 0]),     # all empty
    # the long decode case at llama7b width: 2048 tokens a request
    (8, 32, 1, 1, 128, 1025, 16, 128, [2048] * 8, [1] * 8),
] + LONG_CASES


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", RPA_QUANT_CASES)
def test_quant_attention_kernel_matches_plain(cuda, case, dtype, atol):
    R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args, (ksc, vsc) = _rpa_quant_case(cuda, *case, dtype=dtype,
                                       seed=R + P + d)
    before = (rpa.ragged_paged_attention.launches,
              rpa.ragged_paged_attention.quant_launches)
    out = rpa.ragged_paged_attention(*args, rep=rep, k_scales=ksc,
                                     v_scales=vsc)
    torch.cuda.synchronize()
    assert (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention.quant_launches) == (
        before[0], before[1] + 1)
    ref = rpa._ragged_attention_plain(*args, rep, ksc, vsc)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= atol
    if dtype == torch.bfloat16:
        assert _row_rel(out, ref) <= 2e-2
    tok = torch.arange(Tc * rep, device=cuda) // rep
    pad = tok[None, :] >= args[5][:, None]
    assert not out.float()[pad[:, None, :, None].expand_as(out)].any()


@pytest.mark.parametrize("quant", [False, True])
def test_long_decode_splits_the_walk_in_one_launch(cuda, quant):
    """At the long decode (8 x 2048 tokens, 32 kv heads) the plan splits
    each request's page walk (S > 1), the call is still one launch on
    its counter, a second call gives the same bits (the tickets were
    left at 0), and both agree with the plain version."""
    case = (8, 32, 1, 1, 128, 1025, 16, 128, [2048] * 8, [1] * 8)
    if quant:
        args, (ksc, vsc) = _rpa_quant_case(cuda, *case, dtype=torch.bfloat16,
                                           seed=5)
        kw = dict(k_scales=ksc, v_scales=vsc)
        scales = (ksc, vsc)
    else:
        args = _rpa_case(cuda, *case, dtype=torch.bfloat16, seed=5)
        kw, scales = {}, ()
    plan = rpa._plan_for(args[0], args[1], args[3])
    assert plan.S > 1
    fn = rpa.ragged_paged_attention
    before = (fn.launches, fn.quant_launches)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.quant_launches) == (
        before[0] + (not quant), before[1] + quant)
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not rpa._TICKETS[cuda.index or 0].any()
    ref = rpa._ragged_attention_plain(*args, 1, *scales)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert _row_rel(out, ref) <= 2e-2


def test_quant_attention_kernel_refuses_what_it_cannot_serve(cuda):
    args, (ksc, vsc) = _rpa_quant_case(cuda, 1, 2, 1, 1, 128, 4, 16, 1,
                                       [3], [1], torch.bfloat16, 0)
    q, kp, vp, tbl, lens, qlens = args
    with pytest.raises(ValueError, match="int8 pools need"):
        rpa.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="k_scales must be"):
        rpa.ragged_paged_attention(*args, k_scales=ksc.double(),
                                   v_scales=vsc)
    with pytest.raises(TypeError, match="float32 or bfloat16 q"):
        rpa.ragged_paged_attention(q.half(), kp, vp, tbl, lens, qlens,
                                   k_scales=ksc, v_scales=vsc)
    # a pool view that starts off the 16-byte grid
    flat = torch.zeros(kp.numel() + 1, dtype=torch.int8, device=cuda)
    off = flat[1:].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rpa.ragged_paged_attention(q, off, vp, tbl, lens, qlens,
                                   k_scales=ksc, v_scales=vsc)


def test_forward_paged_int8_kv_on_the_card_matches_the_cpu(cuda):
    """The small model's mixed step over int8 pools: the card (int8
    matmul, the quantize-on-write ops, the int8 attention kernel)
    against the CPU.  Logits to 1e-2 as above; the written pools equal
    except +-1 on a rounding tie, on at most 0.1 % of the bytes; scales
    to 1e-5 relative (an absmax over differently summed f32 products);
    the null page untouched."""
    cfg = tllama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, quantized="on")
    params = tllama.quantize_params(
        cfg, tllama.init_params(cfg, 0, device="cpu"))
    rng = np.random.RandomState(1)
    R, Tc, P, page, Bmax = 4, 8, 16, 16, 3
    tbl = torch.from_numpy((1 + rng.permutation(P - 1)[:R * Bmax])
                           .reshape(R, Bmax).astype(np.int32))
    lens = torch.tensor([8, 1, 0, 6], dtype=torch.int32)
    qlens = torch.tensor([8, 1, 0, 6], dtype=torch.int32)
    tokens = torch.from_numpy(rng.randint(0, 512, (R, Tc)).astype(np.int32))
    outs = []
    for dev in ("cpu", cuda):
        pools = [torch.zeros((2, 1, P, page, 128), dtype=torch.int8,
                             device=dev) for _ in range(2)]
        scales = [torch.ones((2, 1, P), device=dev) for _ in range(2)]
        before = rpa.ragged_paged_attention.quant_launches
        logits, _ = tllama.forward_paged(
            cfg, convert.params_to(params, dev), tokens.to(dev), *pools,
            tbl.to(dev), lens.to(dev), qlens.to(dev), k_scales=scales[0],
            v_scales=scales[1])
        if dev != "cpu":
            assert rpa.ragged_paged_attention.quant_launches == before + 2
        outs.append([logits.cpu()] + [t.cpu() for t in pools + scales])
    for r, q in enumerate(qlens.tolist()):
        if q:
            diff = (outs[0][0][r, :q] - outs[1][0][r, :q]).abs().max()
            assert diff.item() <= 1e-2, (r, diff)
    for a, b in zip(outs[0][1:3], outs[1][1:3]):
        d = a.int() - b.int()
        assert d.abs().max().item() <= 1
        assert d.count_nonzero().item() <= 1e-3 * d.numel()
        assert not b[:, :, 0].any()
    for a, b in zip(outs[0][3:], outs[1][3:]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=0)


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


def _check_bwd(got, q, k, v, o, lse, do):
    """flash_bwd's (dq, dk, dv) against the plain backward run in f32 on
    the kernels' own o and lse."""
    f = [t.float() for t in (q, k, v, do)]
    ref = fa._flash_bwd_plain(*f[:3], o.float(), lse, f[3])
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel(g, r) <= 2e-2
        assert _row_rel(g, r) <= 2e-2


# S: one row, tails below, at and off one tile and two (the forward's
# 128-row q tiles and 128-key ring stages, the backward's 128-key blocks
# and 64-row q stages), 1000 (no multiple of either), the bench's 2048
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 17, 127, 128, 129, 200, 257, 1000, 2048])
def test_flash_kernels_match_plain(cuda, S, D):
    B, H = (2, 3) if S < 1000 else (1, 2)
    q, k, v, do = _qkvd(cuda, B, S, H, D, seed=S + D)
    counts = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(q, k, v)
    grads = fa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == tuple(
        c + 1 for c in counts)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa._flash_fwd_plain(*f[:3])
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert _row_rel(o, o_ref) <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_bwd(grads, q, k, v, o, lse, do)


def test_flash_fwd_twice_in_a_row_is_bit_identical(cuda):
    """Every element of o and lse has one writer and a fixed order of
    summation: a second call on the same inputs gives the same bits."""
    q, k, v, _ = _qkvd(cuda, 2, 1000, 3, 128, seed=4)
    first = fa.flash_fwd(q, k, v)
    second = fa.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_fwd_replays_in_a_cuda_graph(cuda):
    """A forward captured in a CUDA graph and replayed (as chip_smoke.py
    times it) writes the eager call's o and lse, bit for bit."""
    q, k, v, _ = _qkvd(cuda, 2, 1000, 2, 64, seed=8)
    eager = fa.flash_fwd(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_fwd(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_fwd(q, k, v)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, out):
        assert torch.equal(a, b)


def test_flash_bwd_twice_in_a_row_agrees(cuda):
    """Every call's pre-pass zeroes the dq turn counters, the key tiles
    add their dq parts in key-tile order, and dk and dv have one writer
    each: a second call on the same inputs gives the same bits."""
    q, k, v, do = _qkvd(cuda, 2, 1000, 3, 128, seed=5)
    o, lse = fa.flash_fwd(q, k, v)
    first = fa.flash_bwd(q, k, v, o, lse, do)
    second = fa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_bwd(second, q, k, v, o, lse, do)


def test_flash_bwd_replays_in_a_cuda_graph(cuda):
    """A call captured in a CUDA graph and replayed (as chip_smoke.py
    times it) gives the eager call's gradients, bit for bit: no host
    sync, no memset outside the graph, the dq sum in a fixed order."""
    q, k, v, do = _qkvd(cuda, 2, 1000, 2, 128, seed=9)
    o, lse = fa.flash_fwd(q, k, v)
    eager = fa.flash_bwd(q, k, v, o, lse, do)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_bwd(q, k, v, o, lse, do)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, out):
        assert torch.equal(a, b)
    _check_bwd(out, q, k, v, o, lse, do)


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

    before = fa.flash_bwd.launches
    got = run(q, k, v)
    assert fa.flash_bwd.launches == before + 1
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
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    total, ce = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                             "labels": ids})
    total.backward()
    torch.cuda.synchronize()
    after = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    fwd = 2 if policy == "none" else 4
    assert tuple(a - b for a, b in zip(after, before)) == (fwd, 2)
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
    # tile; H = 128 is one N tile of every GEMM; I = 640 (an odd multiple
    # of 128) gives the gate/up launch an odd number of 128-wide dual
    # tiles and the da product a partial 256-wide tile, and H = 384 the
    # same to dxn and the down product; the last is the bench's width at
    # a short S
    (1, 200, 256, 128, 512), (2, 77, 256, 64, 512), (2, 77, 128, 128, 256),
    (1, 200, 384, 128, 640), (1, 200, 2048, 128, 5632),
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


def _fused_call(t, which):
    """A call of the qkv kernel, the MLP forward or its dx, as a tuple of
    its outputs."""
    if which == "qkv":
        return lambda: fb.fused_qkv(t["x"], t["ln"], *t["w"][:3], t["sin"],
                                    t["cos"], head_dim=t["sin"].shape[1])
    if which == "fwd":
        return lambda: (fb.fused_mlp_fwd(t["x"], t["ln"], t["wg"], t["wu"],
                                         t["wd"]),)
    return lambda: (fb.fused_mlp_bwd_dx(t["x"], t["ln"], t["wg"], t["wu"],
                                        t["wd"], t["dy"]),)


@pytest.mark.parametrize("which", ["qkv", "fwd", "bwd_dx"])
def test_fused_kernels_twice_in_a_row_are_bit_identical(cuda, which):
    """Every output element of the qkv and MLP kernels has one writer and
    a fixed order of summation: a second call on the same inputs gives
    the same bits (q, k and v each)."""
    call = _fused_call(_fused_inputs(cuda, 1, 200, 384, 128, 640, seed=12),
                       which)
    first = call()
    second = call()
    torch.cuda.synchronize()
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["qkv", "fwd", "bwd_dx"])
def test_fused_kernels_replay_in_a_cuda_graph(cuda, which):
    """A call captured in a CUDA graph and replayed (as chip_smoke.py
    times it) writes the eager call's outputs, bit for bit: the tensor
    maps are built on the host at capture, the workspaces come from the
    graph's pool."""
    call = _fused_call(_fused_inputs(cuda, 2, 77, 256, 64, 640, seed=13),
                       which)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, out, strict=True):
        assert torch.equal(a, b)


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
                fb.fused_mlp_bwd_dx, fa.flash_fwd, fa.flash_bwd)
    before = [w.launches for w in wrappers]
    total, ce = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                             "labels": ids})
    total.backward()
    torch.cuda.synchronize()
    fwd = 2 if policy == "none" else 4
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        fwd, fwd, fwd, 2, 0, 2]
    assert torch.isfinite(ce)
    assert all(torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_moe_train_step_launches_rows_1_to_8(cuda, policy):
    """The same step with 4 experts (top 2): the fused attention block
    engages as in the dense step (rows 7-8, and the flash backward, rows
    3-6, once per layer), and the MoE layer takes the MLP's place, so
    the fused MLP kernels (rows 9-10) never launch."""
    cfg = tllama.LlamaConfig(vocab_size=128, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=64, moe_num_experts=4,
                             use_remat=policy != "none", remat_policy="dots")
    params = tllama.init_params(cfg, 0, device=cuda)
    leaves = list(tllama._paths(params).values())
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.randint(0, 128, (2, 64), device=cuda)
    wrappers = (fb.fused_qkv, fb.fused_attn_epilogue, fb.fused_mlp_fwd,
                fb.fused_mlp_bwd_dx, fa.flash_fwd, fa.flash_bwd)
    before = [w.launches for w in wrappers]
    total, ce = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                             "labels": ids})
    total.backward()
    torch.cuda.synchronize()
    fwd = 2 if policy == "none" else 4
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        fwd, fwd, 0, 0, 0, 2]
    assert torch.isfinite(total) and total.item() != ce.item()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


# ---------------------------------------------------------------------------
# the model families' front ends
# ---------------------------------------------------------------------------

def test_flash_kernels_match_plain_at_gpt2_smalls_call(cuda):
    """GPT-2 small's attention call: B 8, S 1024, 12 heads of 64."""
    B, S, H, D = 8, 1024, 12, 64
    q, k, v, do = _qkvd(cuda, B, S, H, D, seed=7)
    o, lse = fa.flash_fwd(q, k, v)
    grads = fa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa._flash_fwd_plain(*(t.float() for t in (q, k, v)))
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert _row_rel(o, o_ref) <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_bwd(grads, q, k, v, o, lse, do)


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_train_step_flash_launches(cuda, remat):
    """One GPT step at GPT-2 small's head dim: the flash forward once a
    layer (twice under remat: the backward recomputes it), the backward
    once a layer."""
    from paddle_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=512, hidden_size=256,
                         num_hidden_layers=3, num_attention_heads=4,
                         max_position_embeddings=128, use_remat=remat)
    params = tgpt.init_params(cfg, 0, device=cuda)
    leaves = list(tllama._paths(params).values())
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.randint(0, 512, (2, 128), device=cuda)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    loss = tgpt.loss_fn(cfg, params, {"input_ids": ids, "labels": ids})
    loss.backward()
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert (fa.flash_fwd.launches - before[0],
            fa.flash_bwd.launches - before[1]) == ((2 * L if remat else L), L)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    # float32 on the card raises in the kernel (no quiet plain route)
    f32 = tgpt.GPTConfig(**{**cfg.__dict__, "dtype": torch.float32})
    with pytest.raises(TypeError, match="takes bfloat16"):
        tgpt.forward_pure(f32, tgpt.init_params(f32, 0, device=cuda), ids)


def test_llama7b_shape_generate_launches_int8_matmul_225_a_step(cuda):
    """llama7b's width over int8 weights at 2 of its 32 layers (the
    count is 7 a layer + the head): the prefill and every decode step
    launch the int8 matmul 7 L + 1 times."""
    cfg = tllama.preset("llama7b", num_hidden_layers=2)
    params = tllama.quantize_params(cfg, tllama.init_params(cfg, 0,
                                                            device=cuda))
    ids = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    calls = 7 * cfg.num_hidden_layers + 1
    before = i8.int8_matmul.launches
    toks = tllama.generate(cfg, params, ids, 4)
    torch.cuda.synchronize()
    assert i8.int8_matmul.launches - before == 4 * calls
    assert toks.shape == (2, 4) and bool((toks < cfg.vocab_size).all())
    assert 7 * 32 + 1 == 225


def test_eager_llama_step_launches_rows_7_to_10_and_flash_bwd(cuda):
    """The eager core's train step (``LlamaForCausalLM`` as a ``Layer``
    on the card, ``loss.backward()``, ``AdamW.step()``) at a small bf16
    shape under "dots": the forward kernels of rows 7-9 twice a layer
    (remat recomputes them), row 10 and ``flash_bwd`` once, ``flash_fwd``
    not at all, as the functional step; the parameters stay leaves on
    the card."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    paddle.seed(0)
    cfg = tllama.LlamaConfig(vocab_size=128, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=64, use_remat=True,
                             remat_policy="dots")
    net = tllama.LlamaForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    ids = paddle.randint(0, 128, [2, 64])
    wrappers = (fb.fused_qkv, fb.fused_attn_epilogue, fb.fused_mlp_fwd,
                fb.fused_mlp_bwd_dx, fa.flash_fwd, fa.flash_bwd)
    before = [w.launches for w in wrappers]
    loss, _ = net(ids, labels=ids)
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        4, 4, 4, 2, 0, 2]
    assert np.isfinite(loss.item())
    assert all(p.is_leaf and p.place == paddle.CUDAPlace(0)
               for p in net.parameters())


# QuantizedLinear's int8 product (not a kernel of the reference: its
# static-scale product is outside any Pallas call): torch._int_mm where
# its rules hold (M > 16, K and N multiples of 8), else the float64
# product; each route's int32 accumulator equals the CPU's int32 product
@pytest.mark.parametrize("M,K,N", [(64, 2048, 1000), (17, 64, 8),
                                   (16, 64, 8), (64, 36, 40), (3, 5, 7),
                                   (512, 4096, 4096)])
def test_quantized_linear_routes_are_bit_equal(cuda, M, K, N):
    from paddle_tpu_torch.quantization.quantized_layers import int8_product
    g = torch.Generator().manual_seed(M * K + N)
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    want = xq.int() @ w.int()
    got = int8_product(xq.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    f64 = (xq.to(cuda).double() @ w.to(cuda).double()).to(torch.int32)
    assert torch.equal(f64.cpu(), want)
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        assert torch.equal(torch._int_mm(xq.to(cuda), w.to(cuda)).cpu(),
                           want)
