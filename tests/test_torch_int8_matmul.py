"""The port's int8 weight matmul against the JAX reference.

``quantize_int8`` must give the reference's int8 weights and scales
exactly (dead and non-finite channels included), and the plain PyTorch
int8 matmul must reproduce ``_int8_matmul_jnp``: the same int8
activations and int32 accumulators exactly, outputs within 1 float32
ulp (the f32 epilogue is two roundings; the order is the same, so in
practice they are equal).  Inputs are made by numpy from fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from paddle_tpu.ops import pallas_ops
from paddle_tpu_torch.ops import int8_matmul as port


def _jax_quantize_rows(x):
    """The reference's activation quantization, step for step as in
    ``_int8_matmul_jnp`` (which does not return its intermediates)."""
    xf = jnp.asarray(x, jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    xs = jnp.maximum(amax, pallas_ops._INT8_EPS) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return xq, xs


def _weights(rng, K, N):
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    q, s = pallas_ops.quantize_int8(jnp.asarray(w))
    return np.array(q), np.array(s)   # writable copies for torch


def test_quantize_int8_matches_reference_exactly():
    rng = np.random.RandomState(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0                    # dead channel
    w[5, 7] = np.inf                 # non-finite channels
    w[9, 11] = -np.inf
    w[2, 13] = np.nan
    w[:, 17] = 1e-30                 # tiny, but finite and non-zero
    q_ref, s_ref = pallas_ops.quantize_int8(jnp.asarray(w))
    q, s = port.quantize_int8(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (1, 40)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # the dead-channel guard: benign 1/127, and the channel quantizes to 0
    assert s[0, 3].item() == np.float32(1.0 / 127.0)
    assert not q[:, 3].any()


def test_quantize_int8_stacked_layers_match_reference():
    rng = np.random.RandomState(1)
    w = rng.standard_normal((3, 32, 24)).astype(np.float32) * 0.02
    q_ref, s_ref = pallas_ops.quantize_int8(jnp.asarray(w))
    q, s = port.quantize_int8(torch.from_numpy(w))
    assert tuple(s.shape) == (3, 1, 24)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _check_plain_against_reference(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :] = 0.0                    # an all-zero row: xs floors at eps
    wq, ws = _weights(rng, K, N)

    xq_ref, xs_ref = _jax_quantize_rows(x)
    xq, xs = port._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_ref))

    acc_ref = lax.dot_general(xq_ref, jnp.asarray(wq),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    acc = xq.int() @ torch.from_numpy(wq).int()
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))

    y_ref = np.asarray(pallas_ops._int8_matmul_jnp(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    y = port._int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                torch.from_numpy(ws)).numpy()
    assert y.dtype == np.float32
    np.testing.assert_array_max_ulp(y, y_ref, maxulp=1)
    assert not y[0].any()


def _kernel_verify_int8_shapes():
    shapes = []
    for name, _fn, avals in pallas_ops.kernel_verify_cases():
        if name == "int8_matmul":
            (M, K), (_, N) = avals[0].shape, avals[1].shape
            shapes.append((M, K, N))
    return shapes


def test_plain_matches_reference_at_kernel_verify_shapes():
    shapes = _kernel_verify_int8_shapes()
    assert shapes, "kernel_verify_cases() lists no int8_matmul case"
    for i, (M, K, N) in enumerate(shapes):
        _check_plain_against_reference(M, K, N, seed=10 + i)


@pytest.mark.parametrize("M,K,N", [
    (1, 64, 32),      # one decode row
    (5, 96, 40),      # M < 8: the TPU path falls back here
    (8, 72, 200),     # K, N not multiples of 128
    (13, 130, 36),
    (64, 256, 384),
])
def test_plain_matches_reference(M, K, N):
    _check_plain_against_reference(M, K, N, seed=M + K + N)


def test_plain_bf16_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    wq, ws = _weights(rng, 64, 48)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_ref = np.asarray(pallas_ops._int8_matmul_jnp(
        xb, jnp.asarray(wq), jnp.asarray(ws)).astype(jnp.float32))
    y = port._int8_matmul_plain(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(wq), torch.from_numpy(ws))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), y_ref)


def test_wrapper_on_cpu_is_the_plain_version_with_leading_dims():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    wq, ws = _weights(rng, 64, 24)
    before = port.int8_matmul.launches
    y = port.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                         torch.from_numpy(ws).reshape(24))
    assert tuple(y.shape) == (2, 3, 24)
    ref = port._int8_matmul_plain(torch.from_numpy(x.reshape(6, 64)),
                                  torch.from_numpy(wq),
                                  torch.from_numpy(ws))
    torch.testing.assert_close(y.reshape(6, 24), ref, rtol=0, atol=0)
    # the plain version is not a kernel launch
    assert port.int8_matmul.launches == before


def test_wrapper_raises_on_a_device_without_a_kernel():
    x = torch.empty((4, 8), device="meta")
    wq = torch.empty((8, 4), dtype=torch.int8, device="meta")
    ws = torch.empty((1, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port.int8_matmul(x, wq, ws)


# prefill sizes: the rows the kernel's rows regime serves (a chunk of 8
# requests), in float32 and bfloat16
@pytest.mark.parametrize("M,K,N", [(512, 256, 384), (64, 1024, 256)])
def test_plain_matches_reference_at_prefill_sizes(M, K, N):
    _check_plain_against_reference(M, K, N, seed=M + K + N)


@pytest.mark.parametrize("M,K,N", [(512, 256, 384), (64, 1024, 256)])
def test_plain_bf16_matches_reference_at_prefill_sizes(M, K, N):
    rng = np.random.RandomState(M + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[3, 5] = 200.0                  # an outlier row: it quantizes to 127
    wq, ws = _weights(rng, K, N)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_ref = np.asarray(pallas_ops._int8_matmul_jnp(
        xb, jnp.asarray(wq), jnp.asarray(ws)).astype(jnp.float32))
    y = port._int8_matmul_plain(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(wq), torch.from_numpy(ws))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), y_ref)


# llama7b's int8 matmul shapes (K, N) and the rows the engine sends:
# decode, the regime threshold's two sides, prefill chunks, a long prompt
LLAMA7B_KN = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
PLAN_ROWS = [1, 8, 9, 16, 17, 64, 512, 4096]


@pytest.mark.parametrize("M", PLAN_ROWS)
@pytest.mark.parametrize("K,N", LLAMA7B_KN)
def test_split_plan_fits_the_card(M, K, N):
    """The launch plan from shapes only (132 multiprocessors): the grid
    within CUDA's limits, the K split one portable cluster (<= 8 blocks)
    whose slices cover K exactly with none empty, the shared memory
    within the opt-in limit for bfloat16 and float32 activations, the
    regime by M, no more than two blocks a multiprocessor from the
    split."""
    p = port._split_plan(M, K, N, 132)
    assert p.rows == (16 if M <= 8 else 64 if M <= 64 else 128)
    assert p.launches == (1 if M <= 8 else 2)
    assert p.tiles_n * port._BN >= N > (p.tiles_n - 1) * port._BN
    assert p.tiles_m * p.rows >= M > (p.tiles_m - 1) * p.rows
    assert p.tiles_m < 2 ** 31 and p.tiles_n <= 65535
    bk = port._SHAPES[p.rows][0]
    assert 1 <= p.S <= 8 and p.kslice % bk == 0
    assert p.S * p.kslice >= K > (p.S - 1) * p.kslice
    for xbytes in (2, 4):     # within the 227 KB a block may opt into
        assert port._split_plan(M, K, N, 132, xbytes=xbytes).smem <= 232448
    if p.S > 1:
        assert p.tiles_n * p.tiles_m * p.S <= 2 * 132


def test_split_plan_forced_rows_regime_and_limits():
    assert port._split_plan(8, 4096, 4096, 132, stream_rows=0).rows == 64
    assert port._split_plan(16, 4096, 4096, 132, stream_rows=16).rows == 16
    with pytest.raises(ValueError, match="at most 16"):
        port._split_plan(8, 4096, 4096, 132, stream_rows=32)
    with pytest.raises(ValueError, match="column tiles"):
        port._split_plan(8, 64, 128 * 65536, 132)
    with pytest.raises(ValueError, match="empty"):
        port._split_plan(0, 64, 128, 132)


@pytest.mark.parametrize("M,K,N", [(8, 1100, 256), (16, 4096, 128),
                                   (64, 1000, 384), (200, 520, 300)])
def test_split_plan_emulated_matches_reference(M, K, N):
    """The kernel's arithmetic by the plan, emulated on the CPU: the
    stream regime's row absmax as the max over the K slices' absmaxes,
    the int32 sums per slice, added over the cluster, then the epilogue.
    Equal to the JAX reference's int8 matmul bit for bit."""
    rng = np.random.RandomState(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0
    wq, ws = _weights(rng, K, N)
    p = port._split_plan(M, K, N, 132)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wq).int()
    cuts = [(s * p.kslice, min(K, (s + 1) * p.kslice)) for s in range(p.S)]
    amax = torch.stack([xt[:, a:b].abs().amax(-1) for a, b in cuts]).amax(0)
    xs = torch.clamp_min(amax, port._INT8_EPS)[:, None] * port._INV127
    xq = torch.round(xt / xs).clamp_(-127, 127).int()
    acc = sum(xq[:, a:b] @ wt[a:b] for a, b in cuts)
    y = (acc.float() * xs) * torch.from_numpy(ws)
    y_ref = np.asarray(pallas_ops._int8_matmul_jnp(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    np.testing.assert_array_max_ulp(y.numpy(), y_ref, maxulp=1)
    assert torch.equal(y, port._int8_matmul_plain(xt, torch.from_numpy(wq),
                                                  torch.from_numpy(ws)))


def _kernel_quant(v, s):
    """The kernel's ``quant1``, in float32: rint(v * (1 / s)), and the
    IEEE division only where the product lies within 1e-3 of a half
    integer; clamped to +-127."""
    v, s = np.float32(v), np.float32(s)
    r = np.float32(1) / s
    a = (v * r).astype(np.float32)
    q = np.rint(a)
    near = np.abs(np.abs(a - q) - np.float32(0.5)) < np.float32(1e-3)
    q = np.where(near, np.rint((v / s).astype(np.float32)), q)
    return np.clip(q, -127, 127)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_quantization_without_division_is_exact(seed):
    """The kernel quantizes with a reciprocal and falls back to the
    division near rounding ties: bit for bit the plain version's
    clamp(rint(x / xs)), on random rows, on rows whose values sit on and
    next to every half integer of the grid, and on outliers."""
    rng = np.random.RandomState(seed)
    rows = [rng.standard_normal(4096).astype(np.float32)
            * np.float32(10.0 ** rng.uniform(-6, 3)) for _ in range(6)]
    amax = np.float32(3.7)
    s = np.float32(max(amax, 1e-8)) * np.float32(1.0 / 127.0)
    ties = (np.arange(-127, 127) + np.float32(0.5)).astype(np.float32) * s
    near = np.concatenate([np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, -np.float32(np.inf)), ties])
    rows.append(np.concatenate([near, [amax, -amax]]).astype(np.float32))
    out = rng.standard_normal(4096).astype(np.float32)
    out[17] = np.float32(5e3)
    rows.append(out)
    for x in rows:
        xt = torch.from_numpy(x[None, :])
        xq, xs = port._quantize_rows(xt)
        got = _kernel_quant(x, xs.item())
        np.testing.assert_array_equal(got, xq.numpy()[0].astype(np.float32))
