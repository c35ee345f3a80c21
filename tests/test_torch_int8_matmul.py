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
