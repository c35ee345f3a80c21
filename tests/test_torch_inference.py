"""inference/, onnx/ and the C serving ABI in the port against the
reference: the Predictor (positional and handle protocol, ``clone``,
its device), ``convert_to_mixed_precision``, the C library and a C host
built with ``g++`` and run on the CPU, and the quantize-and-serve
example (``paddle_tpu_torch/{inference,onnx,capi}/``,
``paddle_tpu_torch/examples/{quantize_serve.py,serve_capi.c}``;
reference ``paddle_tpu/inference/``, ``csrc/predictor_capi.cc`` and
their tests ``tests/test_jit_inference.py``,
``tests/test_inference_convert.py``, ``tests/test_capi_predictor.py``).

Tolerances: the port's Predictor and its C host equal the port's eager
model bit for bit; against the reference's Predictor on the same
weights rtol / atol 1e-5; the int8 conversion's ``::q`` / ``::scale``
payload bit-equal to the reference's on the same weights; converted
artifacts served within 2e-2 (bf16) and 6e-2 (int8 weights) of float32,
the reference's own bounds.
"""
import hashlib
import os
import pickle
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import inference as JI
import paddle_tpu_torch as tp
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.inference import capi
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.profiler import metrics, xmem


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _cpu_config(prefix):
    c = TI.Config(prefix + ".pdmodel")
    c.disable_gpu()
    return c


def _mlp(pkg, i=64, h=128, o=32):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(i, h), nn.ReLU(), nn.Linear(h, o))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same MLP saved by both packages at [4, 32] float32, and the
    reference's converted payloads (the JAX side built once)."""
    d = tmp_path_factory.mktemp("saved")
    tp.set_device("cpu")
    jp.seed(11)
    jnet = _mlp(jp)
    tnet = _mlp(tp)
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    spec = [([4, 64], "float32")]
    jp.jit.save(jnet, str(d / "j"), input_spec=[jp.jit.InputSpec(*spec[0])])
    tp.jit.save(tnet, str(d / "t"), input_spec=[InputSpec(*spec[0])])
    ref = np.asarray(JI.create_predictor(JI.Config(str(d / "j"))).run(
        [x])[0])
    JI.convert_to_mixed_precision(str(d / "j"), str(d / "j_int8"), "int8")
    from paddle_tpu.framework.io import load as jload
    j_int8 = {k: np.asarray(v.numpy())
              for k, v in jload(str(d / "j_int8.pdiparams")).items()}
    return dict(dir=d, prefix=str(d / "t"), net=tnet, x=x, ref=ref,
                j_int8=j_int8)


def test_predictor_positional_handles_and_clone(saved):
    pred = TI.create_predictor(_cpu_config(saved["prefix"]))
    eager = saved["net"](tp.to_tensor(saved["x"])).numpy()
    got = pred.run([saved["x"]])[0]
    assert np.array_equal(got, eager)
    np.testing.assert_allclose(got, saved["ref"], rtol=1e-5, atol=1e-5)
    assert pred.get_input_names() == ["input_0"]
    h = pred.get_input_handle("input_0")
    h.copy_from_cpu(saved["x"])
    assert h.shape() == [4, 64]
    pred.run()
    assert pred.get_output_names() == ["output_0"]
    assert np.array_equal(pred.get_output_handle("output_0").copy_to_cpu(),
                          eager)
    assert np.array_equal(pred.clone().run([saved["x"]])[0], eager)
    # copy semantics: the handle keeps its own copy
    x = saved["x"].copy()
    h.copy_from_cpu(x)
    x[:] = 0
    assert np.array_equal(pred.run()[0], eager)


def test_predictor_device_follows_the_config(saved, monkeypatch):
    c = TI.Config(saved["prefix"])
    assert c.prog_file() == saved["prefix"] + ".pdmodel"
    assert c.params_file() == saved["prefix"] + ".pdiparams"
    c.disable_gpu()
    assert TI.create_predictor(c)._device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.create_predictor(c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.create_predictor(TI.Config(saved["prefix"]))
    # jit.load takes the device it is given, not the current place
    assert tp.jit.load(saved["prefix"], device="cpu")._params[0].device \
        == torch.device("cpu")


def test_predictor_metrics_and_xmem(saved):
    from paddle_tpu_torch import flags
    metrics.reset()
    xmem.reset()
    flags.set_flags({"FLAGS_tpu_metrics": True, "FLAGS_tpu_xmem": True})
    try:
        pred = TI.create_predictor(_cpu_config(saved["prefix"]))
        a = pred.run([saved["x"]])[0]
        b = pred.run([saved["x"]])[0]
        snap = metrics.snapshot()
        profiles = [p for p in xmem.profiles() if p["source"] == "predictor"]
    finally:
        flags.set_flags({"FLAGS_tpu_metrics": False, "FLAGS_tpu_xmem": False})
        metrics.reset()
        xmem.reset()
    assert np.array_equal(a, b)
    assert snap["predictor_requests_total"] == 2
    assert len(profiles) == 1 and profiles[0]["output_bytes"] == 4 * 32 * 4


def test_int8_conversion_payload_equals_the_reference(saved, tmp_path):
    dst = TI.convert_to_mixed_precision(saved["prefix"],
                                        str(tmp_path / "t_int8"), "int8",
                                        device="cpu")
    from paddle_tpu_torch.framework.io import load
    got = {k: v.numpy() for k, v in load(dst + ".pdiparams").items()}
    want = saved["j_int8"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    # the reference's scale rule on the same weights, and small tensors
    # kept float32
    from paddle_tpu.inference.convert import _absmax_scale
    w = saved["net"].state_dict()["0.weight"].numpy()
    assert np.array_equal(got["0.weight::scale"], _absmax_scale(w, axis=1))
    assert got["0.bias"].dtype == np.float32 and got["0.bias"].size < 1024
    out = TI.create_predictor(_cpu_config(dst)).run([saved["x"]])[0]
    np.testing.assert_allclose(out, saved["ref"], rtol=6e-2, atol=6e-2)
    assert os.path.getsize(dst + ".pdiparams") < \
        0.5 * os.path.getsize(saved["prefix"] + ".pdiparams")
    with open(dst + ".meta", "rb") as f:
        assert pickle.load(f)["precision"] == "int8"


def test_bf16_conversion_and_a_bf16_artifact_left_as_it_is(saved, tmp_path):
    dst = TI.convert_to_mixed_precision(saved["prefix"],
                                        str(tmp_path / "t_bf16"), device="cpu")
    out = TI.create_predictor(_cpu_config(dst)).run([saved["x"]])[0]
    np.testing.assert_allclose(out, saved["ref"], rtol=2e-2, atol=2e-2)
    assert os.path.getsize(dst + ".pdiparams") < \
        0.75 * os.path.getsize(saved["prefix"] + ".pdiparams")
    # a bf16 artifact: only float32/float64 arrays convert, so under
    # 'int8' (and 'bfloat16') its payload stays as it was
    net = _mlp(tp).to(dtype="bfloat16")
    src = str(tmp_path / "bf16")
    tp.jit.save(net, src, input_spec=[InputSpec([2, 64], "bfloat16")])
    from paddle_tpu_torch.framework.io import load
    before = load(src + ".pdiparams")
    for prec in ("int8", "bfloat16"):
        d = TI.convert_to_mixed_precision(src, str(tmp_path / prec), prec,
                                          device="cpu")
        after = load(d + ".pdiparams")
        assert sorted(after) == sorted(before)
        assert all(torch.equal(_raw(after[k]), _raw(before[k]))
                   for k in before)


def _raw(v):
    return v._t if hasattr(v, "_t") else v


def test_conversion_keeps_a_dynamic_batch(tmp_path):
    from paddle_tpu_torch import static
    main = static.Program()
    tp.enable_static()
    try:
        with static.program_guard(main):
            x = static.data("x", [None, 16])
            out = static.nn.fc(x, 4, activation="relu")
        prefix = str(tmp_path / "dyn")
        static.save_inference_model(prefix, [x], [out], static.Executor(),
                                    program=main)
    finally:
        tp.disable_static()
    dst = TI.convert_to_mixed_precision(prefix, str(tmp_path / "dyn_bf16"),
                                        "bfloat16", device="cpu")
    pred = TI.create_predictor(_cpu_config(dst))
    for batch in (2, 9):
        o = pred.run([np.random.default_rng(batch).standard_normal(
            (batch, 16)).astype(np.float32)])
        assert o[0].shape == (batch, 4)
    with open(dst + ".meta", "rb") as f:
        assert pickle.load(f)["input_specs"][0][0] == [None, 16]


class _Flat(tp.nn.Layer):
    """A graph that bakes its batch: the reshape reads ``x.shape[0]``,
    which ``jit.save`` captures at 1 for a -1 dimension."""

    def __init__(self):
        super().__init__()
        self.fc = tp.nn.Linear(64, 32)

    def forward(self, x):
        return tp.reshape(self.fc(x), [x.shape[0] * 32])


def test_conversion_of_a_baked_batch_warns_and_says_so(tmp_path):
    net = _Flat()
    src = str(tmp_path / "m")
    tp.jit.save(net, src, input_spec=[InputSpec([-1, 64], "float32")])
    with pytest.warns(RuntimeWarning, match="baked as 1"):
        dst = TI.convert_to_mixed_precision(src, str(tmp_path / "m_bf16"),
                                            "bfloat16", device="cpu")
    with open(dst + ".meta", "rb") as f:
        assert pickle.load(f)["input_specs"] == [([1, 64], "float32")]
    x = np.ones((1, 64), np.float32)
    np.testing.assert_allclose(
        TI.create_predictor(_cpu_config(dst)).run([x])[0],
        net(tp.to_tensor(x)).numpy(), rtol=2e-2, atol=2e-2)


def test_conversion_refusals_match_the_reference(saved, tmp_path):
    src = saved["prefix"]
    for mod, prefix in ((JI, str(saved["dir"] / "j")), (TI, src)):
        with pytest.raises(ValueError, match="unsupported precision"):
            mod.convert_to_mixed_precision(prefix, str(tmp_path / "x"),
                                           "int4")
        with pytest.raises(FileNotFoundError, match="pdmodel"):
            mod.convert_to_mixed_precision(str(tmp_path / "none"),
                                           str(tmp_path / "x"), "int8")
    for ext in (".pdmodel", ".pdiparams"):
        os.link(src + ext, str(tmp_path / ("nometa" + ext)))
    with pytest.raises(FileNotFoundError, match=r"\.meta"):
        TI.convert_to_mixed_precision(str(tmp_path / "nometa"),
                                      str(tmp_path / "x"), "int8",
                                      device="cpu")
    with open(str(tmp_path / "nometa.meta"), "wb") as f:
        pickle.dump({"state_names": []}, f)
    with pytest.raises(ValueError, match="no input_specs"):
        TI.convert_to_mixed_precision(str(tmp_path / "nometa"),
                                      str(tmp_path / "x"), "int8",
                                      device="cpu")


def test_int8_artifact_serves_its_eager_bits(tmp_path):
    from paddle_tpu_torch import quantization as Q
    tp.seed(0)
    nn = tp.nn
    net = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                        nn.Flatten(), nn.Linear(8 * 8 * 8, 24))
    net.eval()
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.QuanterFactory(Q.KLObserver),
                              weight=Q.QuanterFactory(Q.AbsmaxObserver)))
    observed = ptq.quantize(net)
    rng = np.random.default_rng(0)
    for b in rng.standard_normal((2, 20, 3, 8, 8)).astype(np.float32):
        observed(tp.to_tensor(b))
    q = ptq.convert(observed, to_int8=True)
    x = rng.standard_normal((20, 3, 8, 8)).astype(np.float32)
    for model, name in ((q, "q"), (net, "f")):
        tp.jit.save(model, str(tmp_path / name),
                    input_spec=[InputSpec([20, 3, 8, 8], "float32")])
    got = TI.create_predictor(_cpu_config(str(tmp_path / "q"))).run([x])[0]
    assert np.array_equal(got, q(tp.to_tensor(x)).numpy())
    with open(str(tmp_path / "q.meta"), "rb") as f:
        names = pickle.load(f)["state_names"]
    assert "0.qweight" in names and "0._conv.weight" not in names
    assert os.path.getsize(str(tmp_path / "q.pdiparams")) < \
        0.5 * os.path.getsize(str(tmp_path / "f.pdiparams"))


@pytest.fixture(scope="module")
def c_host(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    tp.set_device("cpu")
    lib = capi.build(out_dir=str(d))
    host = capi.build_host(os.path.join(capi.CAPI_DIR, "capi_host.c"),
                           str(d / "host"), lib)
    example = capi.build_host(
        os.path.join(os.path.dirname(capi.CAPI_DIR), "examples",
                     "serve_capi.c"), str(d / "serve"), lib)
    return host, example, capi.host_env("cpu")


def test_c_host_serves_the_predictor_s_bits(saved, c_host, tmp_path):
    host, _, env = c_host
    x = saved["x"]
    x.tofile(str(tmp_path / "x.bin"))
    want = TI.create_predictor(_cpu_config(saved["prefix"])).run([x])[0]
    proc = subprocess.run(
        [host, saved["prefix"], str(tmp_path / "x.bin"), "0", "2", "4", "64",
         "2", "--badshape"], capture_output=True, text=True, env=env,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = {ln.split()[0]: ln.split()[1:] for ln in proc.stdout.splitlines()}
    assert lines["OUTPUT"][:5] == ["0", "0", "2", "4", "32"]
    assert lines["OUTPUT"][-1] == hashlib.sha256(want.tobytes()).hexdigest()
    assert float(lines["CREATE_S"][0]) > 0
    assert "shape" in " ".join(lines["BADSHAPE"])
    assert proc.stdout.count("RUN_MS") == 2


def test_c_host_reports_a_missing_model(c_host, tmp_path):
    host, _, env = c_host
    (tmp_path / "x.bin").write_bytes(b"\0" * 32)
    proc = subprocess.run([host, str(tmp_path / "none"),
                           str(tmp_path / "x.bin"), "0", "2", "1", "8"],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 3
    assert "CREATE_ERROR" in proc.stderr and "none.meta" in proc.stderr


def test_serve_capi_example(c_host, tmp_path):
    _, example, env = c_host
    net = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                           tp.nn.Linear(16, 4))
    tp.jit.save(net, str(tmp_path / "model"),
                input_spec=[InputSpec([1, 8], "float32")])
    proc = subprocess.run([example, str(tmp_path / "model")],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "outputs: 1; first tensor dims: 1 4"


def test_quantize_serve_example_on_the_cpu():
    from paddle_tpu_torch.examples import quantize_serve
    res = quantize_serve.main(device="cpu", verbose=False)
    assert res["int8_layers"] == 3 and res["served_equals_eager"]
    assert res["rel_served"] < 0.1 and res["shrink"] < 0.5


def test_onnx_refuses_as_the_reference_does():
    from paddle_tpu import onnx as jonnx
    from paddle_tpu_torch import onnx as tonnx
    assert tonnx.is_supported() == jonnx.is_supported()
    with pytest.raises(NotImplementedError, match="jit.save"):
        tonnx.export(_mlp(tp), "m", input_spec=[InputSpec([1, 64])])
    assert sorted(tonnx.__all__) == sorted(jonnx.__all__)
    assert TI.__all__ == JI.__all__
