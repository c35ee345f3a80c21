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
