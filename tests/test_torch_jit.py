"""jit/ in the port against the reference: ``to_static`` equals eager,
``save`` -> ``load`` equals eager, the capture's cache and accounting;
and the kernel wrappers as ``torch.library`` custom ops, ``_C_ops`` and
``ops.codegen`` (``paddle_tpu_torch/jit/``, ``_C_ops.py``,
``ops/codegen.py``; reference ``paddle_tpu/jit/`` and its tests
``tests/test_jit_inference.py``, less the Predictor).

Weights cross from the reference's layers as numpy; outputs agree to
rtol 1e-5, and a port's ``to_static`` / loaded output equals its own
eager output bit for bit.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.jit.api import count_custom_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.jit.enable_to_static(True)


def _nets():
    jp.seed(42)
    jnet = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.ReLU(),
                            jp.nn.Linear(16, 4))
    tnet = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                            tp.nn.Linear(16, 4))
    tnet.set_state_dict({k: v.numpy() for k, v in
                         jnet.state_dict().items()})
    return jnet, tnet


def test_to_static_matches_eager():
    jnet, tnet = _nets()
    x = np.random.default_rng(0).standard_normal((3, 8)).astype("float32")
    ref = jnet(jp.to_tensor(x)).numpy()
    eager = tnet(tp.to_tensor(x))
    snet = tp.jit.to_static(tnet)
    static = snet(tp.to_tensor(x))
    assert torch.equal(static._t, eager._t)
    assert static._t.grad_fn is None      # outputs carry no tape
    np.testing.assert_allclose(static.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the reference's own to_static on the same weights
    np.testing.assert_allclose(
        static.numpy(), jp.jit.to_static(jnet)(jp.to_tensor(x)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_jit_save_load_roundtrip(tmp_path):
    jnet, tnet = _nets()
    x = np.random.default_rng(1).standard_normal((2, 8)).astype("float32")
    ref = jnet(jp.to_tensor(x)).numpy()
    path = str(tmp_path / "model")
    tp.jit.save(tnet, path, input_spec=[InputSpec([-1, 8], "float32")])
    assert os.path.exists(path + ".pdmodel")
    assert os.path.exists(path + ".pdiparams")
    loaded = tp.jit.load(path)
    out = loaded(x[:1])     # a -1 dimension is exported as 1
    got = out.numpy() if not isinstance(out, (list, tuple)) \
        else out[0].numpy()
    np.testing.assert_allclose(got, ref[:1], rtol=1e-5, atol=1e-6)
    assert torch.equal(out._t, tnet(tp.to_tensor(x[:1]))._t)
    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)
    assert meta["input_specs"] == [([-1, 8], "float32")]
    # .pdiparams holds the weights, .pdmodel only the graph
    nbytes = sum(p._t.numel() * p._t.element_size()
                 for p in tnet.parameters())
    assert nbytes <= os.path.getsize(path + ".pdiparams") < nbytes + (1 << 20)
    assert sorted(loaded.state_dict()) == sorted(tnet.state_dict())


def test_function_save_load_roundtrip(tmp_path):
    @tp.jit.to_static
    def poly(x):
        return x * x + 2.0 * x + 1.0

    prefix = str(tmp_path / "fn_model")
    tp.jit.save(poly, prefix, input_spec=[InputSpec([4], "float32")])
    loaded = tp.jit.load(prefix)
    x = np.arange(4, dtype=np.float32)
    got = loaded(x)
    got = got.numpy() if hasattr(got, "numpy") else got[0].numpy()
    np.testing.assert_allclose(got, (x + 1) ** 2, rtol=1e-6)


def _tiny_llama_cfgs(fused_blocks):
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.models import llama as tl
    kw = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, max_position_embeddings=64)
    import jax.numpy as jnp
    return jl, tl, jl.LlamaConfig(dtype=jnp.float32, **kw), tl.LlamaConfig(
        dtype=torch.float32, fused_blocks=fused_blocks, **kw)


def test_llama_fused_to_static_save_load_holds_the_custom_ops(tmp_path):
    """A small LlamaForCausalLM on the fused route with CPU tensors:
    ``to_static`` and a reload give the eager logits bit for bit, the
    captured graph holds the kernels' custom ops once a layer each (the
    eager forward's launches of rows 7-9 on the card), one capture for
    repeated calls and one more for a new shape; the logits agree with
    the reference's."""
    _llama_capture_round_trip(tmp_path, "on", (
        "fused_qkv", "fused_attn_epilogue", "fused_mlp_fwd"))


def test_llama_unfused_to_static_save_load_holds_flash_fwd(tmp_path):
    """The same on the unfused route: the capture and the saved program
    hold ``flash_fwd`` (rows 1-2) once a layer, and the replay and a
    reload give the eager logits bit for bit."""
    _llama_capture_round_trip(tmp_path, "off", ("flash_fwd",))


def _llama_capture_round_trip(tmp_path, fused_blocks, ops):
    from paddle_tpu_torch.profiler import compile_tracker
    jl, tl, jcfg, tcfg = _tiny_llama_cfgs(fused_blocks)
    jnet = jl.LlamaForCausalLM(jcfg)
    net = tl.LlamaForCausalLM(tcfg)
    net.set_state_dict({k: v.numpy() for k, v in jnet.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    eager = net(tp.to_tensor(ids))
    np.testing.assert_allclose(
        eager.numpy(), jnet(jp.to_tensor(ids)).numpy(), rtol=2e-4,
        atol=2e-5)
    compile_tracker.reset()
    snet = tp.jit.to_static(net)
    out = snet(tp.to_tensor(ids))
    assert torch.equal(out._t, eager._t)
    L = tcfg.num_hidden_layers
    assert count_custom_ops(net.forward) == {op: L for op in ops}
    snet(tp.to_tensor(ids))
    fn = compile_tracker.stats()["functions"]["LlamaForCausalLM.forward"]
    assert fn == {"traces": 1, "retraces": 0}
    snet(tp.to_tensor(ids[:, :8]))
    fn = compile_tracker.stats()["functions"]["LlamaForCausalLM.forward"]
    assert fn == {"traces": 2, "retraces": 1}

    prefix = str(tmp_path / "llama")
    tp.jit.save(net, prefix, input_spec=[InputSpec([2, 16], "int64")])
    with open(prefix + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    assert count_custom_ops(ep) == {op: L for op in ops}
    nbytes = sum(p._t.numel() * p._t.element_size()
                 for p in net.parameters())
    assert os.path.getsize(prefix + ".pdmodel") < nbytes // 4
    assert nbytes <= os.path.getsize(prefix + ".pdiparams") \
        < nbytes + (1 << 20)
    np.save(str(tmp_path / "ids.npy"), ids)
    np.save(str(tmp_path / "want.npy"), eager.numpy())
    # a fresh process that imports only the port loads and runs it
    code = (
        "import sys, numpy as np, torch\n"
        "import paddle_tpu_torch as paddle\n"
        "assert 'jax' not in sys.modules and 'paddle_tpu' not in sys.modules\n"
        "paddle.set_device('cpu')\n"
        f"m = paddle.jit.load({prefix!r})\n"
        f"ids = np.load({str(tmp_path / 'ids.npy')!r})\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "got = m(ids).numpy()\n"
        "assert np.array_equal(got, want), np.abs(got - want).max()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]


def test_translator_switches_and_cache():
    calls = []

    @tp.jit.to_static
    def f(x, k):
        calls.append(1)
        return x * k

    x = tp.to_tensor(np.array([1.0], np.float32))
    f(x, 2.0)
    f(x, 2.0)
    assert len(calls) == 1           # one capture for repeated calls
    f(x, 3.0)
    assert len(calls) == 2           # a new static leaf: a new capture
    tp.jit.enable_to_static(False)
    f(x, 2.0)
    assert len(calls) == 3           # the original body, eagerly
    tp.jit.enable_to_static(True)
    tp.jit.set_verbosity(0)
    tp.jit.set_code_level(0)
    g = tp.jit.not_to_static(lambda v: v + 1.0)
    assert getattr(g, "_not_to_static", False)
    with pytest.raises(NotImplementedError, match="A item 8"):
        tp.jit.to_static(lambda v: v, lint=True)
    with pytest.raises(NotImplementedError, match="A item 8"):
        tp.incubate.autotune.set_config({"kernel": {"enable": True}})


def test_new_signatures_report_to_xmem_chaos_and_the_watchdog():
    """A new signature's replay is profiled by xmem (when it is on) and
    passes the ``jit.compile`` chaos point; a cached one does neither."""
    from paddle_tpu_torch.profiler import xmem
    from paddle_tpu_torch.testing import chaos
    _, tnet = _nets()
    f = tp.jit.to_static(tnet.forward)
    x = tp.to_tensor(np.ones((2, 8), np.float32))
    xmem.reset()
    tp.set_flags({"FLAGS_tpu_xmem": True})
    try:
        f(x)
        f(x)
    finally:
        tp.set_flags({"FLAGS_tpu_xmem": False})
    profs = [p for p in xmem.profiles() if p["source"] == "to_static"]
    assert len(profs) == 1 and profs[0]["flops"] > 0
    assert profs[0]["output_bytes"] == 2 * 4 * 4
    with chaos.installed("fail@jit.compile:times=1"):
        with pytest.raises(Exception):
            f(tp.to_tensor(np.ones((3, 8), np.float32)))
        f(x)            # cached: no chaos point
    xmem.reset()


def test_cache_evicts_with_a_warning(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", "2")

    @tp.jit.to_static
    def f(x, k):
        return x * k
    x = tp.to_tensor(np.array([1.0], np.float32))
    with pytest.warns(UserWarning, match="evicting"):
        for k in range(4):
            f(x, float(k))
    assert len(f._cache) == 2


def test_traced_layer_and_numerics_watch():
    from paddle_tpu_torch.profiler import numerics
    jnet, tnet = _nets()
    x = tp.to_tensor(np.ones((2, 8), np.float32))
    outs, traced = tp.jit.TracedLayer.trace(tnet, [x])
    assert torch.equal(traced([x])._t, outs._t)

    @tp.jit.to_static
    def bad(v):
        return tp.log(v)
    tp.set_flags({"FLAGS_tpu_check_nan_inf": True})
    try:
        numerics.reset()
        with pytest.warns(RuntimeWarning, match="non-finite"):
            bad(tp.to_tensor(np.array([-1.0], np.float32)))
        assert any(k.startswith("to_static:") and v["nonfinite"]
                   for k, v in numerics.sites().items())
    finally:
        tp.set_flags({"FLAGS_tpu_check_nan_inf": False})
        numerics.reset()


def test_custom_ops_route_and_count_on_the_cpu():
    """The wrappers run the custom ops' CPU registrations (the plain
    versions) and count nothing; other devices raise in the wrapper."""
    from paddle_tpu_torch.ops import codegen
    from paddle_tpu_torch.ops import fused_blocks as fb
    before = {n: getattr(fn, "launches", None) for n, fn, *_ in
              codegen.fused_parity_cases()}
    for name, fn, plain, make in codegen.fused_parity_cases():
        args = make(0)
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert fb.fused_qkv.launches == 0 or before
    meta = torch.empty((1, 4, 128), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fb.fused_mlp_fwd(meta, meta, meta, meta, meta)


def test_kernel_verify_cases_check_the_shapes_under_fake_cuda():
    from paddle_tpu_torch.ops import codegen
    cases = codegen.kernel_verify_cases()
    assert [c[0] for c in cases] == ["flash_fwd", "fused_qkv",
                                     "fused_attn_epilogue", "fused_mlp_fwd"]
    shapes = {c[0]: codegen.verify_case(c) for c in cases}
    assert shapes["fused_qkv"] == [((1, 256, 256), torch.bfloat16)] * 3
    assert shapes["fused_attn_epilogue"][2] == ((1, 2, 256), torch.float32)
    name, op, specs, extra = cases[3]
    bad = ((specs[0][0], torch.float32),) + specs[1:]
    with pytest.raises(TypeError, match="bfloat16"):
        codegen.verify_case((name, op, bad, extra))


def test_c_ops_and_manifest_against_the_reference():
    from paddle_tpu import _C_ops as j_c_ops
    from paddle_tpu.ops import codegen as jcg
    from paddle_tpu_torch.ops import codegen as tcg
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    y = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    for name in ("exp", "add", "matmul", "tanh"):
        args = (x, y.T) if name == "matmul" else (x, y) if name == "add" \
            else (x,)
        got = getattr(tp._C_ops, name)(*[torch.as_tensor(a) for a in args])
        want = getattr(j_c_ops, name)(*[np.asarray(a) for a in args])
        assert torch.is_tensor(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(AttributeError):
        tp._C_ops.no_such_op
    text = tcg.export_manifest()
    assert text.count("- op : ") == len(tp.ops.registry.OP_LIBRARY) == 385
    # every op of the reference's generated sweep is in the port's
    mine = {n for n, *_ in tcg.parity_cases()}
    assert {n for n, *_ in jcg.parity_cases()} <= mine
    for name, lowering, np_fn, n in tcg.parity_cases():
        if n != 1:
            continue
        v = np.linspace(0.1, 0.9, 7).astype(np.float32)
        try:
            want = np.asarray(np_fn(v))
        except (TypeError, ValueError):   # numpy refuses this input
            continue
        got = lowering(torch.as_tensor(v))
        np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                                   want.astype(np.float64), rtol=2e-5,
                                   atol=1e-6, err_msg=name)
