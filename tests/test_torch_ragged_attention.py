"""The port's ragged paged attention against the JAX reference.

The plain PyTorch version is held against ``_ragged_attention_jnp`` and
against the Pallas kernel itself, run in interpret mode at the page size
the TPU kernel takes (128).  float32 throughout; atol 1e-5 covers the
different summation order of the dense softmax, the online softmax and
the CPU einsums.  Padding rows and empty slots must be exact zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ops
from paddle_tpu_torch.ops import ragged_paged_attention as port

ATOL = 1e-5


@pytest.fixture
def interpret_mode():
    old = pallas_ops._INTERPRET
    pallas_ops._INTERPRET = True
    yield
    pallas_ops._INTERPRET = old


def _case(R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens, seed):
    rng = np.random.RandomState(seed)
    Tr = Tc * rep
    q = rng.standard_normal((R, nkv, Tr, d)).astype(np.float32)
    kp = rng.standard_normal((nkv, P, page, d)).astype(np.float32)
    vp = rng.standard_normal((nkv, P, page, d)).astype(np.float32)
    pages = 1 + rng.permutation(P - 1)[:R * Bmax]   # distinct, page 0 free
    tbl = pages.reshape(R, Bmax).astype(np.int32)
    return (q, kp, vp, tbl, np.asarray(seq_lens, np.int32),
            np.asarray(q_lens, np.int32))


def _port(args, rep):
    q, kp, vp, tbl, lens, qlens = (torch.from_numpy(a) for a in args)
    return port._ragged_attention_plain(q, kp, vp, tbl, lens, qlens,
                                        rep).numpy()


def _jnp(args, rep):
    return np.asarray(pallas_ops._ragged_attention_jnp(
        *(jnp.asarray(a) for a in args), rep))


def _assert_padding_zero(out, q_lens, rep):
    tok = np.arange(out.shape[2]) // rep
    pad = tok[None, :] >= np.asarray(q_lens)[:, None]        # [R, Tr]
    assert np.all(out[np.broadcast_to(pad[:, None, :, None], out.shape)]
                  == 0.0)


# (name, R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens)
CASES = [
    # slot 0 full prefill, 1 decode, 2 chunked tail across a page
    # boundary, 3 empty
    ("mixed", 4, 2, 1, 8, 32, 32, 16, 4, [40, 17, 64, 0], [8, 1, 3, 0]),
    ("decode", 8, 2, 1, 1, 32, 64, 16, 4,
     [1, 17, 33, 64, 5, 9, 0, 50], [1, 1, 1, 1, 1, 1, 0, 1]),
    ("gqa_rep2", 4, 2, 2, 4, 32, 32, 8, 4, [20, 9, 32, 0], [4, 2, 1, 0]),
    ("empty_slots", 4, 2, 2, 2, 16, 16, 8, 2, [0, 3, 0, 0], [0, 2, 0, 0]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jnp_reference(case):
    _, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args = _case(R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens, seed=R + P)
    out = _port(args, rep)
    np.testing.assert_allclose(out, _jnp(args, rep), rtol=0, atol=ATOL)
    _assert_padding_zero(out, qlens, rep)


# page 128: the geometry the Pallas kernel runs at
KERNEL_CASES = [
    ("mixed", 3, 2, 1, 4, 32, 8, 128, 2, [200, 129, 0], [4, 1, 0]),
    ("decode", 4, 2, 1, 1, 32, 10, 128, 2, [1, 128, 200, 0], [1, 1, 1, 0]),
    ("gqa_rep2", 2, 2, 2, 4, 32, 8, 128, 2, [130, 3], [4, 3]),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_plain_matches_pallas_kernel_interpret(case, interpret_mode):
    _, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args = _case(R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens, seed=P + d)
    ref = np.asarray(pallas_ops._rpa_call(
        *(jnp.asarray(a) for a in args), rep=rep, bq_rows=Tc * rep))
    out = _port(args, rep)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    _assert_padding_zero(out, qlens, rep)
    _assert_padding_zero(ref, qlens, rep)


def test_wrapper_on_cpu_is_the_plain_version():
    args = _case(2, 2, 2, 3, 16, 8, 8, 2, [10, 2], [3, 2], seed=9)
    before = port.ragged_paged_attention.launches
    tens = [torch.from_numpy(a) for a in args]
    out = port.ragged_paged_attention(*tens, rep=2)
    torch.testing.assert_close(out, torch.from_numpy(_port(args, 2)),
                               rtol=0, atol=0)
    assert port.ragged_paged_attention.launches == before


def test_plain_keeps_bf16_dtype_and_zero_padding():
    args = _case(2, 2, 1, 4, 16, 8, 8, 2, [12, 0], [4, 0], seed=3)
    tens = [torch.from_numpy(a) for a in args]
    tens[:3] = [t.bfloat16() for t in tens[:3]]
    out = port._ragged_attention_plain(*tens, 1)
    assert out.dtype == torch.bfloat16
    assert not out[1].any()


def test_wrapper_raises_on_a_device_without_a_kernel():
    q = torch.empty((1, 1, 1, 16), device="meta")
    kp = torch.empty((1, 2, 8, 16), device="meta")
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    lens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no kernel"):
        port.ragged_paged_attention(q, kp, kp, tbl, lens, lens)


# ---------------------------------------------------------------------------
# int8 pools with per-page f32 scales (the port of _rpa_kernel_quant)
# ---------------------------------------------------------------------------

def _quant_case(R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens, seed):
    """As ``_case``, with int8 pools and scales [nkv, P] in the range
    quantize-on-write gives unit-scale activations (absmax / 127)."""
    q, _, _, tbl, lens, qlens = _case(R, nkv, rep, Tc, d, P, page, Bmax,
                                      seq_lens, q_lens, seed)
    rng = np.random.RandomState(seed + 1)
    kp = rng.randint(-127, 128, (nkv, P, page, d)).astype(np.int8)
    vp = rng.randint(-127, 128, (nkv, P, page, d)).astype(np.int8)
    ksc = rng.uniform(0.005, 0.03, (nkv, P)).astype(np.float32)
    vsc = rng.uniform(0.005, 0.03, (nkv, P)).astype(np.float32)
    return (q, kp, vp, tbl, lens, qlens), (ksc, vsc)


def _port_quant(args, scales, rep):
    q, kp, vp, tbl, lens, qlens = (torch.from_numpy(a) for a in args)
    ksc, vsc = (torch.from_numpy(s) for s in scales)
    return port._ragged_attention_plain(q, kp, vp, tbl, lens, qlens, rep,
                                        ksc, vsc).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_quant_plain_matches_jnp_reference(case):
    _, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args, scales = _quant_case(R, nkv, rep, Tc, d, P, page, Bmax, lens,
                               qlens, seed=R + P + 1)
    ref = np.asarray(pallas_ops._ragged_attention_jnp(
        *(jnp.asarray(a) for a in args), rep,
        *(jnp.asarray(s) for s in scales)))
    out = _port_quant(args, scales, rep)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    _assert_padding_zero(out, qlens, rep)


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_quant_plain_matches_pallas_kernel_interpret(case, interpret_mode):
    _, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    args, scales = _quant_case(R, nkv, rep, Tc, d, P, page, Bmax, lens,
                               qlens, seed=P + d + 1)
    ksc, vsc = (jnp.asarray(s) for s in scales)
    ref = np.asarray(pallas_ops._rpa_call(
        *(jnp.asarray(a) for a in args), rep=rep, bq_rows=Tc * rep,
        k_scales=ksc, v_scales=vsc))
    out = _port_quant(args, scales, rep)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    _assert_padding_zero(out, qlens, rep)


def test_quant_wrapper_on_cpu_is_the_plain_version():
    args, scales = _quant_case(2, 2, 2, 3, 16, 8, 8, 2, [10, 2], [3, 2],
                               seed=11)
    before = (port.ragged_paged_attention.launches,
              port.ragged_paged_attention.quant_launches)
    tens = [torch.from_numpy(a) for a in args]
    ksc, vsc = (torch.from_numpy(s) for s in scales)
    out = port.ragged_paged_attention(*tens, rep=2, k_scales=ksc,
                                      v_scales=vsc)
    torch.testing.assert_close(
        out, torch.from_numpy(_port_quant(args, scales, 2)), rtol=0, atol=0)
    assert (port.ragged_paged_attention.launches,
            port.ragged_paged_attention.quant_launches) == before


def test_quant_wrapper_refuses_mismatched_pools_and_scales():
    args, scales = _quant_case(1, 2, 1, 2, 16, 4, 8, 2, [5], [2], seed=5)
    q, kp, vp, tbl, lens, qlens = (torch.from_numpy(a) for a in args)
    ksc, vsc = (torch.from_numpy(s) for s in scales)
    call = port.ragged_paged_attention
    with pytest.raises(ValueError, match="int8 pools need"):
        call(q, kp, vp, tbl, lens, qlens)
    with pytest.raises(TypeError, match="scales go with int8 pools"):
        call(q, kp.float(), vp.float(), tbl, lens, qlens, k_scales=ksc,
             v_scales=vsc)
    with pytest.raises(ValueError, match="come together"):
        call(q, kp, vp, tbl, lens, qlens, k_scales=ksc)
    for bad in (ksc.double(), ksc[:, :3], ksc.t().contiguous().t()[:, :],
                torch.ones((2, 8))[:, ::2]):
        with pytest.raises(ValueError, match="k_scales must be"):
            call(q, kp, vp, tbl, lens, qlens, k_scales=bad, v_scales=vsc)


# ---------------------------------------------------------------------------
# the kernel's split of the page walk (flash decoding) and its combine.
# The CUDA kernel cannot run here, so its arithmetic is emulated: each
# (request, head, row tile) sees the pages up to its horizon (the last
# key its last real row may see), split s of S owns pages
# [s*n/S, (s+1)*n/S) of those n and reports (m, l, acc); the combine
# weighs each split by exp(m - M) and skips splits with l = 0, and rows
# with l = 0 everywhere are exact zeros.  Held against
# _ragged_attention_jnp in float32 (atol 1e-5: summation order).
# ---------------------------------------------------------------------------

def _split_emulation(q, kp, vp, tbl, lens, qlens, rep, rows, S,
                     ksc=None, vsc=None):
    R, nkv, Tr, d = q.shape
    page = kp.shape[2]
    scale = 1.0 / np.sqrt(d)
    if ksc is not None:     # int8 pages: scale first, dot second
        kp = kp.float() * ksc[:, :, None, None]
        vp = vp.float() * vsc[:, :, None, None]
    out = torch.zeros((R, nkv, Tr, d), dtype=torch.float32)
    for r in range(R):
        kvlen, qlen = int(lens[r]), int(qlens[r])
        for row0 in range(0, Tr, rows):
            nrows = min(rows, Tr - row0)
            if qlen <= 0 or row0 // rep >= qlen:
                continue                      # zeros, no page read
            last_tok = min((row0 + nrows - 1) // rep, qlen - 1)
            kend = min(kvlen, kvlen - qlen + last_tok + 1)
            n = -(-kend // page) if kend > 0 else 0
            tok = (row0 + torch.arange(nrows)) // rep
            qpos = torch.where(tok < qlen, kvlen - qlen + tok,
                               torch.full_like(tok, -1))
            qt = q[r, :, row0:row0 + nrows].float()          # [nkv, n, d]
            parts = []
            for s in range(S):
                j0, j1 = s * n // S, (s + 1) * n // S
                kstart = j0 * page
                kstop = min(j1 * page, kend) if j1 > j0 else kstart
                if kstop <= kstart:           # a split that owns no page
                    parts.append((torch.full((nkv, nrows), -1e30),
                                  torch.zeros((nkv, nrows)),
                                  torch.zeros((nkv, nrows, d))))
                    continue
                pages = tbl[r, j0:j1].long()
                k = kp[:, pages].reshape(nkv, -1, d)[:, :kstop - kstart]
                v = vp[:, pages].reshape(nkv, -1, d)[:, :kstop - kstart]
                sc = torch.einsum("hnd,hkd->hnk", qt, k.float()) * scale
                kpos = kstart + torch.arange(kstop - kstart)
                live = (kpos[None, :] <= qpos[:, None])[None]
                sc = torch.where(live, sc, torch.tensor(-1e30))
                m = sc.amax(-1)
                p = torch.where(live, torch.exp(sc - m[..., None]), 0.0)
                parts.append((m, p.sum(-1),
                              torch.einsum("hnk,hkd->hnd", p, v.float())))
            m = torch.stack([x[0] for x in parts])           # [S, nkv, n]
            l = torch.stack([x[1] for x in parts])
            acc = torch.stack([x[2] for x in parts])
            big = torch.where(l > 0, m, torch.tensor(-1e30)).amax(0)
            w = torch.where(l > 0, torch.exp(m - big), 0.0)
            L = (l * w).sum(0)
            A = (acc * w[..., None]).sum(0)
            out[r, :, row0:row0 + nrows] = torch.where(
                L[..., None] > 0, A / L.clamp_min(1e-30)[..., None], 0.0)
    return out


# (name, R, nkv, rep, Tc, d, P, page, Bmax, seq_lens, q_lens): ragged
# lengths off page boundaries with an empty slot and a one-token request
# (splits that own no page); GQA decode; causal prefill chunks with a
# decode row and an empty slot; GQA chunks
SPLIT_CASES = [
    ("ragged_decode", 8, 2, 1, 1, 64, 80, 8, 9,
     [70, 1, 33, 0, 64, 9, 71, 8], [1, 1, 1, 0, 1, 1, 1, 1]),
    ("gqa_decode", 4, 2, 4, 1, 64, 40, 8, 8, [64, 17, 3, 0], [1, 1, 1, 0]),
    ("prefill_chunks", 4, 2, 1, 20, 64, 48, 8, 11,
     [84, 20, 40, 0], [20, 13, 1, 0]),
    ("gqa_chunks", 3, 2, 2, 8, 64, 32, 16, 4, [45, 8, 20], [8, 3, 5]),
]


@pytest.mark.parametrize("S", [1, 2, 3, 16])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("pools", ["f32", "int8"])
def test_split_and_combine_match_jnp_reference(case, S, pools):
    """Every tiling the kernel picks for this shape (bf16 q: 64-row
    tensor-core tiles past 16 rows; f32 q: rows-kernel tiles) at S
    splits, S = 16 being more than any request's pages."""
    _, R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens = case
    if pools == "f32":
        args = _case(R, nkv, rep, Tc, d, P, page, Bmax, lens, qlens,
                     seed=S + R)
        scales = None
        ref = _jnp(args, rep)
    else:
        args, scales = _quant_case(R, nkv, rep, Tc, d, P, page, Bmax, lens,
                                   qlens, seed=S + R)
        ref = np.asarray(pallas_ops._ragged_attention_jnp(
            *(jnp.asarray(a) for a in args), rep,
            *(jnp.asarray(s) for s in scales)))
    tens = [torch.from_numpy(a) for a in args]
    sc = [torch.from_numpy(s) for s in scales] if scales else [None, None]
    kv_dtype = tens[1].dtype
    tilings = {port._tile_rows(Tc * rep, d, qd, kv_dtype)
               for qd in (torch.bfloat16, torch.float32)}
    for rows in sorted(tilings):
        out = _split_emulation(*tens, rep, rows, S, *sc).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5,
                                   err_msg=f"rows {rows}")
        _assert_padding_zero(out, qlens, rep)


SMS = 132   # H100 SXM


def test_split_plan_stays_within_the_pages():
    for R, nkv, Tr, Bmax, page in [(1, 1, 1, 1, 8), (8, 32, 1, 128, 16),
                                   (8, 32, 1, 3, 16), (8, 8, 4, 128, 16),
                                   (8, 32, 64, 68, 16), (2, 2, 20, 3, 24),
                                   (1, 1, 1, 2048, 8), (64, 32, 1, 8, 8)]:
        for d, qd, kvd in [(128, torch.bfloat16, torch.bfloat16),
                           (128, torch.bfloat16, torch.int8),
                           (64, torch.float32, torch.float32),
                           (128, torch.float32, torch.int8)]:
            plan = port._split_plan(R, nkv, Tr, Bmax, page, SMS, d, qd, kvd)
            assert 1 <= plan.S <= Bmax
            assert plan.ntiles * plan.rows >= Tr > (plan.ntiles - 1) * plan.rows
            assert plan.rows == port.MMA_ROWS or plan.rows <= 16
            assert plan.S <= port._MAX_SPLITS
            part = plan.rows * d + -(-plan.rows // 2) * 4
            want = ((R, nkv, plan.ntiles, plan.S, part)
                    if plan.S > 1 else None)
            assert plan.ws_shape == want and part % 4 == 0


def test_split_plan_does_not_grow_as_the_grid_fills_the_card():
    for d, qd, kvd in [(128, torch.bfloat16, torch.bfloat16),
                       (128, torch.bfloat16, torch.int8),
                       (128, torch.float32, torch.float32)]:
        def S(R=8, nkv=32, Tr=1):
            return port._split_plan(R, nkv, Tr, 128, 16, SMS, d, qd,
                                    kvd).S
        for axis in ("R", "nkv", "Tr"):
            seq = [S(**{axis: n}) for n in range(1, 129)]
            assert all(a >= b for a, b in zip(seq, seq[1:])), (axis, seq)
        assert S(R=1, nkv=1) > S(R=64, nkv=64) == 1


def test_split_plan_splits_the_long_decode_only():
    """decode_long (8 x 2048 tokens, 32 kv heads) splits; the serve
    cell's short shapes (Bmax 3) keep one block a (request, head)."""
    bf = torch.bfloat16
    assert port._split_plan(8, 32, 1, 128, 16, SMS, 128, bf, bf).S > 1
    assert port._split_plan(8, 32, 1, 128, 16, SMS, 128, bf,
                            torch.int8).S > 1
    for Tr in (1, 8, 32):
        assert port._split_plan(8, 32, Tr, 3, 16, SMS, 128, bf, bf).S == 1
