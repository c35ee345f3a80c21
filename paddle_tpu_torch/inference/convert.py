"""Post-export precision conversion for serving artifacts (the port of
``paddle_tpu/inference/convert.py``).

Reference analog: the AnalysisPredictor pass pipeline's
convert_to_mixed_precision
(paddle/fluid/inference/analysis/passes/convert_to_mixed_precision.cc)
and the static post-training quantization passes
(python/paddle/static/quantization/) — transforms applied to a SAVED
model so serving runs in lower precision without retraining.

The ``jit.save`` artifact is a ``torch.export`` program whose state
(the weights, by name) arrives as its first input.  The conversion
rewrites that payload and exports again a wrapper that rebuilds the
original dtypes and calls the loaded program:

- "bfloat16"/"float16": float32/float64 arrays stored in the low dtype,
  cast back at the graph's edge — half the payload and the host to
  device traffic.
- "int8": weight-only post-training quantization of the float32/float64
  arrays with ``ndim >= 2`` and at least ``_INT8_MIN_SIZE`` elements
  (symmetric absmax over every axis but the last, the dead-channel
  guard of ``_absmax_scale``), stored as ``k::q`` / ``k::scale`` and
  dequantized at the graph's edge.

Arrays of other dtypes (bf16 weights, integer buffers) never convert:
a bf16 artifact is left as it is under 'int8' and 'bfloat16'.  The
converted artifact keeps the jit.save format, so the Predictor and the C
serving host load it unchanged.  Dynamic dimensions export again with
one ``torch.export.Dim`` per axis position, traced at 2; a program that
cannot take them (``jit.save`` bakes a -1 as 1) is converted at 1 with a
warning, and the ``.meta`` says so.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["convert_to_mixed_precision"]

# arrays smaller than this stay fp32 under int8 conversion (biases,
# norm scales: quantization would cost accuracy and save nothing)
_INT8_MIN_SIZE = 1024


def _absmax_scale(w: np.ndarray, axis=None) -> np.ndarray:
    """Symmetric absmax scale (quantization/quanters AbsmaxObserver
    rule), per-channel when axis is given.

    Dead (all-zero) and non-finite channels get the benign scale
    1/127: their weights quantize to 0 and dequantize to exact 0.  An
    epsilon clamp is NOT enough — 1e-8/127 ≈ 7.9e-11 underflows to
    exactly 0.0 when a downstream consumer stores the scale in float16
    (subnormal floor ~6e-8), and a zero scale turns dequant into
    inf/NaN."""
    if axis is None:
        m = float(np.max(np.abs(w)))
        if not np.isfinite(m) or m <= 0.0:
            m = 1.0
        return np.asarray(m / 127.0, np.float32)
    m = np.max(np.abs(w), axis=tuple(i for i in range(w.ndim)
                                     if i != axis), keepdims=True)
    m = np.where(np.isfinite(m) & (m > 0.0), m, 1.0)
    return (m / 127.0).astype(np.float32)


def _note_quant_err(name: str, w: np.ndarray, q: np.ndarray,
                    scale: np.ndarray) -> None:
    """Conversion-time quantization-error gauges (rms and absmax of
    dequant - reference per converted array), behind the numerics
    flag."""
    from ..profiler import numerics
    if not numerics.enabled():
        return
    err = q.astype(np.float32) * scale.astype(np.float32) \
        - w.astype(np.float32)
    if err.size == 0:
        return
    numerics.note(f"quant_err_rms_{name}",
                  float(np.sqrt(np.mean(err * err))))
    numerics.note(f"quant_err_absmax_{name}",
                  float(np.max(np.abs(err))))


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype in (torch.float32, torch.float64)


class _Rebuild(torch.nn.Module):
    """``forward(state, *xs)``: the converted payload (by
    ``new_names``) rebuilt into the source program's state (by
    ``names``) in its dtypes, then the source program."""

    def __init__(self, program, names, new_names, plan):
        super().__init__()
        self._program = program
        self._names, self._new_names, self._plan = names, new_names, plan

    def forward(self, state, *xs):
        p = dict(zip(self._new_names, state))
        full = []
        for k in self._names:
            how, dtype = self._plan[k]
            if how == "q":
                full.append((p[k + "::q"].to(torch.float32)
                             * p[k + "::scale"]).to(dtype))
            elif how == "cast":
                full.append(p[k].to(dtype))
            else:
                full.append(p[k])
        return self._program(tuple(full), *xs)


def convert_to_mixed_precision(src_prefix: str, dst_prefix: str,
                               precision: str = "bfloat16",
                               device=None) -> str:
    """Convert a jit.save / save_inference_model artifact in place of
    its weights; returns dst_prefix.  precision: 'bfloat16', 'float16'
    or 'int8' (weight-only).  The program is exported again on
    ``device`` (the card unless the caller names another)."""
    import warnings

    from ..core.tensor import Tensor
    from ..device import resolve_device
    from ..framework.io import load as fload, save as fsave
    # the kernels' custom ops must be registered before the graph loads
    from ..ops import flash_attention, fused_blocks  # noqa: F401

    if precision not in ("bfloat16", "float16", "int8"):
        raise ValueError(
            f"unsupported precision {precision!r}: expected 'bfloat16', "
            "'float16' or 'int8'")
    for ext in (".pdmodel", ".pdiparams"):
        if not os.path.exists(src_prefix + ext):
            raise FileNotFoundError(src_prefix + ext)
    if not os.path.exists(src_prefix + ".meta"):
        # the export below traces the wrapper against the .meta's
        # input_specs; without them it would fail later with a
        # confusing arity/trace error — name the real problem up front
        raise FileNotFoundError(
            f"{src_prefix}.meta: conversion needs the source artifact's "
            ".meta (input_specs) written by save_inference_model; "
            "re-export the source model or pass a prefix that has all "
            "three of .pdmodel/.pdiparams/.meta")
    dev = resolve_device(device)

    with open(src_prefix + ".pdmodel", "rb") as f:
        program = torch.export.load(f).module()
    payload = fload(src_prefix + ".pdiparams")
    meta_path = src_prefix + ".meta"
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    if "input_specs" not in meta:
        # an EMPTY list is legitimate (weights-only artifact); only a
        # .meta that never carried specs is unusable
        raise ValueError(
            f"{meta_path} has no input_specs; the source artifact "
            "predates spec-carrying save_inference_model — re-export it")
    names = meta.get("state_names", list(payload))
    params = {k: (payload[k]._t if isinstance(payload[k], Tensor)
                  else payload[k]) for k in names}

    new_params, plan = {}, {}
    if precision in ("bfloat16", "float16"):
        low = torch.bfloat16 if precision == "bfloat16" else torch.float16
        for k, v in params.items():
            if _is_float(v):
                new_params[k] = v.to(low)
                plan[k] = ("cast", v.dtype)
            else:
                new_params[k] = v
                plan[k] = ("keep", v.dtype)
    else:  # int8 weight-only
        for k, v in params.items():
            if _is_float(v) and v.dim() >= 2 and \
                    v.numel() >= _INT8_MIN_SIZE:
                w = v.cpu().numpy()
                scale = _absmax_scale(w, axis=w.ndim - 1)
                q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
                new_params[k + "::q"] = torch.from_numpy(q)
                new_params[k + "::scale"] = torch.from_numpy(scale)
                plan[k] = ("q", v.dtype)
                _note_quant_err(k, w, q, scale)
            else:
                new_params[k] = v
                plan[k] = ("keep", v.dtype)
    new_names = list(new_params)
    module = _Rebuild(program, names, new_names, plan)
    state = tuple(new_params[k].to(dev) for k in new_names)

    # keep the source artifact's shape polymorphism: dynamic dims export
    # again with ONE shared symbol per axis position (the
    # save_inference_model rule), traced at 2; fall back to baked shapes
    # — and a truthful meta — if the program cannot take them
    specs_meta = meta.get("input_specs", [])
    dyn_axes = sorted({i for shape, _ in specs_meta
                       for i, d in enumerate(shape) if d in (-1, None)})

    def _inputs(symbolic):
        return [torch.zeros([(2 if symbolic else 1) if d in (-1, None)
                             else int(d) for d in shape],
                            dtype=getattr(torch, dt), device=dev)
                for shape, dt in specs_meta]

    def _export(symbolic):
        dyn = None
        if symbolic and dyn_axes:
            syms = {i: torch.export.Dim(f"_ax{i}") for i in dyn_axes}
            dyn = {"state": tuple(None for _ in state),
                   "xs": tuple({i: syms[i] for i, d in enumerate(shape)
                                if d in (-1, None)} or None
                               for shape, _ in specs_meta)}
        with torch.no_grad():
            return torch.export.export(module, (state, *_inputs(symbolic)),
                                       dynamic_shapes=dyn, strict=False)

    polymorphic = bool(dyn_axes)
    try:
        ep = _export(symbolic=True)
    except Exception as e:
        if not dyn_axes:
            raise
        warnings.warn(
            f"convert_to_mixed_precision: shape-polymorphic re-export "
            f"failed ({e}); converting with dynamic dims baked as 1 — "
            "the converted artifact only accepts that shape.",
            RuntimeWarning, stacklevel=2)
        polymorphic = False
        ep = _export(symbolic=False)

    os.makedirs(os.path.dirname(dst_prefix) or ".", exist_ok=True)
    ep._example_inputs = None      # they would hold the weights again
    with open(dst_prefix + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    fsave({k: Tensor._wrap(v) for k, v in new_params.items()},
          dst_prefix + ".pdiparams")
    meta = dict(meta)
    meta["precision"] = precision
    meta["state_names"] = new_names
    if not polymorphic:
        # meta must describe what the artifact actually accepts
        meta["input_specs"] = [
            ([1 if d in (-1, None) else d for d in shape], dt)
            for shape, dt in specs_meta]
    with open(dst_prefix + ".meta", "wb") as f:
        pickle.dump(meta, f)
    return dst_prefix
