"""Inference API — the serving path (the port of
``paddle_tpu/inference/__init__.py``).

Reference analog: paddle/fluid/inference/ AnalysisPredictor
(api/analysis_predictor.h:95) + python/paddle/inference/__init__.py
(Config, create_predictor, Tensor handles).  Here the ``jit.save``
artifact is a ``torch.export`` program whose graph holds the port's
kernels as custom-op nodes; the Predictor loads it with its state onto
the Config's device, binds numpy inputs, runs the graph and returns host
arrays.

The device: ``Config.enable_use_gpu(mb, device_id)`` is
``cuda:device_id``, ``disable_gpu()`` the CPU; with neither the card,
and creating a Predictor without a card raises (the port never picks
the CPU by itself).

Native serving host: ``paddle_tpu_torch/capi/predictor_capi.cc`` is the
C ABI a non-Python serving process links (reference:
paddle/fluid/inference/capi_exp/pd_inference_api.h); ``capi.build()``
compiles it.  Its embedded interpreter drives this module.

Known difference: under ``FLAGS_tpu_xmem`` the reference compiles the
exported module once per input signature to read its memory analysis;
the port has no compile step and reports each new signature's first
run through ``profiler.xmem.capture`` (the caching allocator's peak
around the call), as ``jit.to_static`` does.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .convert import convert_to_mixed_precision  # noqa: F401

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "convert_to_mixed_precision"]


class Config:
    """paddle.inference.Config parity (the knobs that matter here)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._prefix = prog_file
        self._params_file = params_file
        self._memory_optimized = True
        self._ir_optim = True
        self._device = None

    # -- device selection ---------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = ("gpu", int(device_id))

    def enable_xpu(self, *a, **k):
        self._device = ("xpu", 0)

    def disable_gpu(self):
        self._device = ("cpu", 0)

    def set_cpu_math_library_num_threads(self, n):
        pass

    # -- graph opts (stored; torch.export's graph is what runs) --------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag=True):
        self._memory_optimized = flag

    def model_dir(self):
        return os.path.dirname(self._prefix or "")

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._prefix or "") + ".pdiparams"

    def _torch_device(self) -> torch.device:
        """The device the Predictor loads onto: the card unless the
        Config named the CPU; without a card, a raise."""
        from ..device import resolve_device
        if self._device is None:
            return resolve_device()
        kind, idx = self._device
        if kind == "cpu":
            return torch.device("cpu")
        if kind == "gpu":
            resolve_device()            # raises without a card
            return torch.device("cuda", idx)
        raise ValueError(f"the port serves on the card or the CPU, not "
                         f"{kind!r}")


class PredictorTensor:
    """An I/O handle (reference: ZeroCopyTensor) with copy semantics:
    ``copy_from_cpu`` keeps its own copy of the array."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.array(arr, copy=True)

    def copy_to_cpu(self) -> np.ndarray:
        return self._value

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def shape(self):
        return list(self._value.shape) if self._value is not None else None


def _host(t) -> np.ndarray:
    """A host copy; bf16 becomes float32, as ``Tensor.numpy()`` does."""
    t = t._t if hasattr(t, "_t") else t
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Predictor:
    """Loads a jit.save artifact and runs it (AnalysisPredictor analog)."""

    def __init__(self, config: Config):
        from ..jit.api import load as jit_load
        self._config = config
        self._device = config._torch_device()
        self._layer = jit_load(config._prefix, device=self._device)
        meta_path = config._prefix + ".meta"
        self._input_names: List[str] = []
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            n = len(meta.get("input_specs", []))
            self._input_names = [f"input_{i}" for i in range(n)]
        self._inputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n) for n in self._input_names}
        self._outputs: Dict[str, PredictorTensor] = {}
        # input signatures whose first run xmem has profiled
        self._profiled: set = set()

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs.setdefault(name, PredictorTensor(name))

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Either positional numpy inputs (returns list of numpy), or the
        handle protocol (copy_from_cpu -> run() -> copy_to_cpu)."""
        from ..profiler import _record_span, metrics as _metrics
        from ..profiler import xmem as _xmem
        rec = _metrics.enabled()
        t0 = time.perf_counter() if rec else None
        if inputs is None:
            inputs = [self._inputs[n]._value for n in self._input_names]
        with _record_span("predictor_run"):
            xs = [self._on_device(a) for a in inputs]
            state = tuple(self._layer._params)
            with torch.no_grad():
                if _xmem.enabled():
                    outs = self._run_xmem(state, xs)
                else:
                    outs = self._layer._module(state, *xs)
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            arrays = [_host(o) for o in outs]
        self._outputs = {}
        for i, a in enumerate(arrays):
            h = PredictorTensor(f"output_{i}")
            h._value = a
            self._outputs[f"output_{i}"] = h
        if rec:
            _metrics.counter("predictor_requests_total",
                             "Predictor.run() calls").inc()
            _metrics.histogram(
                "predictor_run_seconds",
                "End-to-end Predictor.run() latency").observe(
                    time.perf_counter() - t0)
        return arrays

    def _on_device(self, a) -> torch.Tensor:
        t = a._t if hasattr(a, "_t") else a
        if not torch.is_tensor(t):
            a = np.asarray(t)
            # torch takes no read-only buffer (the C ABI's inputs are)
            t = torch.as_tensor(a if a.flags.writeable else a.copy())
        return t.to(self._device)

    def _run_xmem(self, state, xs):
        """xmem's record of each new input signature's first run: the
        caching allocator's peak around the call (the port has no
        compile step to analyse)."""
        from ..profiler import xmem
        sig = tuple((tuple(x.shape), str(x.dtype)) for x in xs)
        if sig in self._profiled:
            return self._layer._module(state, *xs)
        self._profiled.add(sig)
        name = os.path.basename(self._config._prefix or "predictor")
        out, _ = xmem.capture("predictor", name, self._layer._module,
                              state, *xs, sig=sig)
        return out

    def clone(self):
        return Predictor(self._config)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
