"""The port stands alone: no JAX, no ``paddle_tpu``, no quiet CPU.

``paddle_tpu_torch/`` and ``chip_smoke.py`` may not import ``jax`` or
anything of ``paddle_tpu`` (not even its jax-free modules: the port
keeps its own copies), and an entry point given no device runs on the
card or raises — it never picks the CPU by itself.
"""
import ast
import os
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import LLMEngine

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = _port_files()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    for mod in ("flash_attention", "fused_blocks"):
        assert REPO / "paddle_tpu_torch" / "ops" / f"{mod}.py" in files
    for mod in ("bench_serve.py", "serving/prefix_cache.py",
                "serving/workloads.py", "serving/spec_decode.py",
                "runtime/watchdog.py", "testing/chaos.py",
                "profiler/ledger.py", "models/decoding.py", "models/gpt.py",
                "models/ernie.py", "core/tensor.py", "core/place.py",
                "tensor/math.py", "tensor/manipulation.py",
                "autograd/functional.py", "nn/layer/layers.py",
                "nn/functional/loss.py", "optimizer/optimizer.py",
                "optimizer/lr.py", "testing/op_cases.py",
                "amp/__init__.py", "nn/layer/rnn.py",
                "nn/layer/transformer.py", "nn/decode.py",
                "optimizer/lbfgs.py", "incubate/__init__.py",
                "incubate/nn/functional.py",
                "incubate/nn/fused_transformer.py",
                "incubate/nn/fused_linear.py",
                "incubate/optimizer/lookahead.py",
                "incubate/optimizer/modelaverage.py",
                "incubate/optimizer/distributed_fused_lamb.py",
                "incubate/autograd/__init__.py",
                "quantization/__init__.py", "quantization/functional.py",
                "quantization/quanters.py", "quantization/config.py",
                "quantization/qat.py", "quantization/quantized_layers.py",
                "inference/__init__.py", "inference/convert.py",
                "inference/capi.py", "onnx/__init__.py",
                "examples/quantize_serve.py", "distributed/collective.py",
                "distributed/parallel.py", "distributed/random.py",
                "distributed/recompute.py", "distributed/io.py",
                "distributed/launch_utils.py", "distributed/__init__.py",
                "distributed/fleet/__init__.py",
                "distributed/fleet/mp_layers.py",
                "distributed/fleet/gradient_merge.py",
                "distributed/fleet/localsgd.py",
                "distributed/fleet/utils.py"):
        assert REPO / "paddle_tpu_torch" / mod in files
    bad = []
    for path in files:
        for line, mod in _imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}:{line} imports {mod}")
    assert not bad, "\n".join(bad)


def test_the_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom paddle_tpu.serving import kv_cache\n"
                 "import jax.numpy as jnp\n")
    assert [m for _, m in _imports(f)] == ["os", "paddle_tpu.serving",
                                           "jax.numpy"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card_or_a_device(no_card):
    cfg = tllama.LlamaConfig(vocab_size=32, hidden_size=16,
                             intermediate_size=32, num_hidden_layers=1,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=16,
                             dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(cfg)
    params = tllama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({"w": [[1.0]]})
    # naming the CPU is the one way onto it
    eng = LLMEngine(cfg, params, device="cpu", max_model_len=16)
    assert eng.device.type == "cpu"
    # "auto" quantizes only on the card: the CPU engine keeps dense weights
    assert not isinstance(eng.params["layers"]["wq"], dict)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_train_entry_points_never_pick_the_cpu_themselves(no_card, capsys):
    """The train path: the bench without --device raises (its JSON line
    carries the error and it exits non-zero); forward_pure / loss_fn run
    where the params are, and the params need a device or a card."""
    import json

    from paddle_tpu_torch import bench as tbench
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.measure()
    assert tbench.main([]) != 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "no CUDA device" in line["error"] and line["value"] is None
    cfg = tllama.LlamaConfig(vocab_size=32, hidden_size=32,
                             intermediate_size=32, num_hidden_layers=1,
                             num_attention_heads=2, num_key_value_heads=2,
                             max_position_embeddings=16,
                             dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(cfg)
    params = tllama.init_params(cfg, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    logits, _ = tllama.forward_pure(cfg, params, ids)
    assert logits.device.type == "cpu"
    total, _ = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                            "labels": ids})
    assert total.device.type == "cpu"


def test_model_family_entry_points_never_pick_the_cpu(no_card):
    """GPT, ERNIE, the eager classes and the KV cache: no device and no
    card raises; naming the CPU is the one way onto it."""
    from paddle_tpu_torch.distributed import HybridTopology
    from paddle_tpu_torch.models import decoding, ernie, gpt
    gcfg = gpt.GPTConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, max_position_embeddings=16,
                         dtype=torch.float32)
    ecfg = ernie.ErnieConfig(vocab_size=32, hidden_size=16,
                             num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=32,
                             max_position_embeddings=16)
    lcfg = tllama.LlamaConfig(vocab_size=32, hidden_size=16,
                              intermediate_size=32, num_hidden_layers=1,
                              num_attention_heads=2, num_key_value_heads=2,
                              max_position_embeddings=16,
                              dtype=torch.float32)
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.core import place
    monkey_place = place._CURRENT[0]
    place._CURRENT[0] = None          # no set_device call
    try:
        for make in (lambda: gpt.init_params(gcfg),
                     lambda: ernie.init_params(ecfg),
                     lambda: gpt.GPTForCausalLM(gcfg),
                     lambda: tllama.LlamaForCausalLM(lcfg),
                     lambda: tpaddle.to_tensor([1.0]),
                     lambda: tpaddle.zeros([2]),
                     lambda: tpaddle.nn.Linear(2, 2),
                     lambda: decoding.init_kv_cache(1, 1, 4, 2, 8),
                     lambda: ernie.build_pretrain_step(ecfg,
                                                       HybridTopology())):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        # the eager classes build on the current place: the CPU once named
        tpaddle.set_device("cpu")
        ids = torch.zeros((1, 3), dtype=torch.long)
        m = gpt.GPTForCausalLM(gcfg)
        assert m(ids).place.is_cpu_place()
        assert m.generate(ids, 2).place.is_cpu_place()
    finally:
        place._CURRENT[0] = monkey_place
    step, init = ernie.build_pretrain_step(ecfg, HybridTopology(),
                                           device="cpu")
    params, _ = init(0)
    assert params["word_emb"].device.type == "cpu"


def _embedded_python(path):
    """The Python source embedded in a C++ file's raw string literals
    (``R"PY( ... )PY"``)."""
    import re
    return re.findall(r'R"PY\((.*?)\)PY"', path.read_text(), re.S)


def test_the_c_abi_s_embedded_python_imports_neither(tmp_path):
    src = REPO / "paddle_tpu_torch" / "capi" / "predictor_capi.cc"
    blocks = _embedded_python(src)
    assert len(blocks) == 1 and "paddle_tpu_torch.inference" in blocks[0]
    f = tmp_path / "bootstrap.py"
    f.write_text(blocks[0])
    mods = [m for _, m in _imports(f)]
    assert "paddle_tpu_torch.inference" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
    # the scan sees a forbidden import in such a block
    bad = tmp_path / "bad.cc"
    bad.write_text('const char* k = R"PY(\nimport jax\n)PY";\n')
    f.write_text(_embedded_python(bad)[0])
    assert [m for _, m in _imports(f)] == ["jax"]


def test_inference_config_with_nothing_set_needs_a_card(no_card, tmp_path):
    """``inference.Config()`` names no device: its Predictor goes on the
    card, and without one creating it raises; ``disable_gpu`` is the one
    way onto the CPU."""
    from paddle_tpu_torch import inference
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.Config()._torch_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(inference.Config(str(tmp_path / "m")))
    c = inference.Config()
    c.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        c._torch_device()
    c.disable_gpu()
    assert c._torch_device() == torch.device("cpu")
