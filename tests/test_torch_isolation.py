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
    logits = tllama.forward_pure(cfg, params, ids)
    assert logits.device.type == "cpu"
    total, _ = tllama.loss_fn(cfg, params, {"input_ids": ids,
                                            "labels": ids})
    assert total.device.type == "cpu"
