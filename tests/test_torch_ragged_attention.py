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
