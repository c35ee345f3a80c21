"""paddle.onnx surface (the port of ``paddle_tpu/onnx/__init__.py``;
scope-gated).

Reference analog: python/paddle/onnx/export.py — a thin wrapper over the
external paddle2onnx converter.  No converter ships with this tree, and
the port's serving artifact is ``jit.save``'s ``torch.export`` program,
which ``inference.Predictor`` and the C ABI
(``paddle_tpu_torch/capi/``) serve.  ``export()`` therefore refuses with
a precise error rather than writing a file that is not ONNX.
"""
from __future__ import annotations

__all__ = ["export", "is_supported"]


def is_supported() -> bool:
    """True when a real ONNX converter/runtime is importable."""
    try:
        import onnx  # noqa: F401
        return True
    except ImportError:
        return False


def export(layer, path, input_spec=None, opset_version=9, **configs):
    """Reference signature (python/paddle/onnx/export.py).  Raises and
    points at the supported artifact: ``jit.save`` served by
    ``inference`` or the C ABI."""
    if not is_supported():
        raise NotImplementedError(
            "ONNX export is out of scope: no onnx package in the "
            "environment. The supported serving artifact is jit.save's "
            "torch.export program — use paddle_tpu_torch.jit.save(layer, "
            "path, input_spec=...) and serve it with "
            "paddle_tpu_torch.inference (Python) or the C ABI "
            "(paddle_tpu_torch/capi, inference.capi.build()).")
    raise NotImplementedError(
        "onnx package found, but no paddle2onnx-style converter is "
        "bundled in this tree; export via jit.save instead and serve it "
        "with paddle_tpu_torch.inference or the C ABI.")
