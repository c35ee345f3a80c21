"""The port's numerics watchdog (``paddle_tpu_torch.profiler.numerics``)
against the reference's ``profiler.numerics``.

- The check sites: the same arrays through ``check_array`` /
  ``check_tree`` in each package (numpy arrays in both, and torch
  tensors in the port) give equal ``sites()``, ``collected()``,
  ``last_stats()`` and ``summary_lines()``.
- ``quantize_params``' quantization-error notes equal the reference's
  ``_note_quant_err`` on the same weights at rtol 1e-6 (both reckon in
  float32 numpy).
- ``localize`` is the port's own (the reference's walks a jaxpr and is
  broken on this jax, ROADMAP §C): on a small float32 Llama on the CPU
  with one layer's ``wq`` set to 1e38 (finite; the product overflows),
  it names that layer's ``fused_qkv`` call under the fused blocks
  (``fused_blocks="on"``: the wrappers' plain versions, each checked as
  one op) and an aten matmul of ``llama.py`` under the unfused layer; it
  returns None on the clean model, and reports a non-finite input as
  ``<input>``.
- The serving engine's ``serve.step.logits`` site counts every step.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.models import llama as jllama
from paddle_tpu.profiler import numerics as jnum
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.profiler import numerics as tnum

FLAG = "FLAGS_tpu_check_nan_inf"


@pytest.fixture
def on():
    tflags.set_flags({FLAG: True})
    jflags.set_flags({FLAG: True})
    tnum.reset()
    jnum.reset()
    yield
    tflags.set_flags({FLAG: False})
    jflags.set_flags({FLAG: False})
    tnum.reset()
    jnum.reset()


def _arrays():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = a.copy()
    b[1, 2] = np.nan
    b[3, 0] = np.inf
    b[0, 4] = -np.inf
    c = np.arange(6, dtype=np.int32)
    return a, b, c


def _drive(num, conv):
    a, b, c = (conv(x) for x in _arrays())
    found = [num.check_array(a, "clean"), num.check_array(c, "ints")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        found.append(num.check_array(b, "warned"))
    found.append(num.check_array(b, "collected", action="collect"))
    with pytest.raises(num.NonFiniteError, match="2 Inf"):
        num.check_array(b, "raised", action="raise")
    found.append(num.check_tree({"w": a, "g": (b, c)}, "tree",
                                action="collect"))
    num.note("train_loss", 2.5)
    num.note("loss_scale", float("inf"))
    num.note("quant_err_rms_wq", 0.01)
    return found


@pytest.mark.parametrize("conv", [np.asarray, torch.from_numpy],
                         ids=["numpy", "torch"])
def test_check_sites_equal_reference(on, conv):
    assert _drive(tnum, conv) == _drive(jnum, np.asarray)
    assert tnum.sites() == jnum.sites()
    assert tnum.collected() == jnum.collected()
    assert tnum.last_stats() == jnum.last_stats()
    assert tnum.summary_lines() == jnum.summary_lines()
    assert tnum.sites()["tree[0]"]["last"] == {   # keys sorted: g first
        "nan": 1, "inf": 2, "size": 20, "shape": [4, 5], "dtype": "float32"}


def test_off_is_a_no_op():
    _, b, _ = _arrays()
    assert tnum.check_array(b, "x", action="raise") is False
    assert tnum.sites() == {}
    assert tnum.summary_lines() == jnum.summary_lines() == [
        "Numerics  (FLAGS_tpu_check_nan_inf=off)"]


def test_quant_err_notes_equal_reference(on):
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, quantized="on",
                              **jllama.PRESETS["llama-debug"])
    jp = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(1)))
    jllama.quantize_params(jcfg, jp)
    cfg = tllama.preset("llama-debug", dtype=torch.float32, quantized="on")
    tllama.quantize_params(cfg, convert.params_from_jax(jp, device="cpu"))
    want = jnum.last_stats()
    got = tnum.last_stats()
    assert sorted(got) == sorted(want) and len(got) == 3 * 7 + 2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert any(ln.strip() == "Quantization" for ln in tnum.summary_lines())


def _small(fused):
    cfg = tllama.LlamaConfig(vocab_size=256, hidden_size=128,
                             intermediate_size=256, num_hidden_layers=3,
                             num_attention_heads=2, num_key_value_heads=2,
                             dtype=torch.float32, fused_blocks=fused)
    params = tllama.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 16)))
             for k in ("input_ids", "labels")}
    return cfg, params, batch


def _poisoned(params, layer):
    bad = dict(params)
    bad["layers"] = dict(params["layers"])
    wq = params["layers"]["wq"].detach().clone()
    wq[layer] = 1e38
    bad["layers"]["wq"] = wq
    return bad


def test_localize_names_the_fused_qkv_launch():
    cfg, params, batch = _small("on")
    assert tllama._fused_block_modes(cfg, batch["input_ids"]) == (True,
                                                                  True)

    def step(p):
        loss, _ = tllama.loss_fn(cfg, p, batch)
        return loss

    assert tnum.localize(step, params) is None
    assert math.isfinite(float(step(params)))
    rep = tnum.localize(step, _poisoned(params, 1))
    assert rep["primitive"] == "fused_qkv" and rep["kind"] == "kernel"
    assert rep["call_index"] == 1            # the poisoned layer's call
    assert rep["file"].endswith("fused_blocks.py")
    assert rep["inf"] + rep["nan"] > 0


def test_localize_names_the_aten_matmul_unfused():
    cfg, params, batch = _small("off")

    def step(p):
        return tllama.loss_fn(cfg, p, batch)[0]

    assert tnum.localize(step, params) is None
    rep = tnum.localize(step, _poisoned(params, 2))
    assert rep["kind"] == "aten"
    assert "mm" in rep["primitive"] or "matmul" in rep["primitive"]
    assert rep["file"].endswith("llama.py")
    bad = {"x": torch.tensor([1.0, float("nan")])}
    assert tnum.localize(lambda d: d["x"] * 2, bad)["primitive"] == "<input>"


def test_watch_localizes_and_raises(on):
    cfg, params, batch = _small("on")
    watched = tnum.watch(lambda p: tllama.loss_fn(cfg, p, batch)[0],
                         name="loss")
    watched(params)
    with pytest.raises(tnum.NonFiniteError, match="fused_blocks.py") as e:
        watched(_poisoned(params, 0))
    assert e.value.report["primitive"] == "fused_qkv"
    assert tnum.sites()["loss"] == {"hits": 2, "nonfinite": 1,
                                    "last": tnum.sites()["loss"]["last"]}


def test_engine_logits_site(on):
    cfg = tllama.preset("llama-debug", dtype=torch.float32)
    eng = serving.LLMEngine(cfg, tllama.init_params(cfg, 0, device="cpu"),
                            device="cpu", max_running=2, chunk=4,
                            page_size=8, max_model_len=32)
    rid = eng.add_request([1, 2, 3], 4)
    eng.run()
    assert len(eng.output_of(rid)) == 4
    site = tnum.sites()["serve.step.logits"]
    assert site["hits"] == eng._steps and site["nonfinite"] == 0
