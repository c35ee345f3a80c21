"""to_static / save / load (the port of ``paddle_tpu/jit/api.py``;
reference analog python/paddle/jit/api.py to_static:222, save:773).

One capture mechanism under both: ``torch.export.export(...,
strict=False)`` of a pure function of (state, tensor leaves), where the
state is the Layer's parameters and buffers passed as inputs (swapped
into the facade for the capture), so the graph holds no weights.

- ``to_static`` keeps the reference's contract: tensor leaves are
  traced, every other leaf is baked, one program is cached per
  (treedef, static leaves) under an LRU cap with a warning, and within
  it one capture per shape signature; every new signature is recorded
  in ``profiler.compile_tracker``, passes the ``jit.compile`` chaos
  point and the watchdog's ``compile`` phase, and its first replay is
  profiled by ``profiler.xmem`` when that is on; outputs are scanned for
  NaN/Inf when the numerics flag is on; outputs carry no tape (the
  capture and its replay run under ``no_grad``).  The replay runs the
  captured graph (``ExportedProgram.module()``): the kernels' custom ops
  (``paddle_tpu_torch::flash_fwd``, ``fused_qkv``,
  ``fused_attn_epilogue``, ``fused_mlp_fwd``) are nodes of it.
- ``jit.save`` writes ``.pdmodel`` (``torch.export.save`` of the graph
  at the input specs, a ``-1`` dimension as 1; no weights, no example
  inputs), ``.pdiparams`` (the state dict, ``framework.io.save``) and
  ``.meta`` (the input specs and the state's names).  ``jit.load``
  registers the custom ops (importing the kernel modules), loads the
  graph and places the parameters on the current device.  A ``.pt2`` is
  not the reference's StableHLO: the two packages' artifacts are not
  interchangeable (ROADMAP C).
"""
from __future__ import annotations

import functools
import os
import pickle
import warnings
from collections import OrderedDict
from contextlib import nullcontext
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor

__all__ = ["to_static", "not_to_static", "ignore_module", "TracedLayer",
           "TranslatedLayer", "save", "load", "InputSpec", "StaticFunction",
           "enable_to_static", "set_verbosity", "set_code_level"]

_ITEM8 = ("ROADMAP A item 8 (analysis and autotune): the port has no "
          "trace-time lint yet")


class InputSpec:
    """reference: python/paddle/static/input.py InputSpec."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)})")


def _is_dynamic_leaf(x) -> bool:
    return isinstance(x, (Tensor, torch.Tensor, np.ndarray))


def _to_raw(tree):
    return pytree.tree_map(lambda v: v._t if isinstance(v, Tensor) else v,
                           tree)


def _to_facade(tree):
    return pytree.tree_map(
        lambda v: Tensor._wrap(v) if torch.is_tensor(v) else v, tree)


def _layer_of(fn):
    from ..nn.layer.layers import Layer
    owner = getattr(fn, "__self__", None)
    return owner if isinstance(owner, Layer) else None


def _state_of(layer) -> List[Tensor]:
    """The Layer's parameters and buffers, the state a capture takes as
    inputs (in ``state_dict`` order)."""
    if layer is None:
        return []
    return list(layer.parameters()) + list(layer.buffers())


class _Capture(torch.nn.Module):
    """``forward(state, *dyn)``: the state swapped into the facade, the
    function called on the tensor leaves (the static leaves baked), its
    outputs as torch tensors."""

    def __init__(self, fn, state, rebuild):
        super().__init__()
        self._fn, self._state, self._rebuild = fn, state, rebuild

    def forward(self, state, *dyn):
        old = [t._t for t in self._state]
        try:
            for t, s in zip(self._state, state):
                t._t = s
            args, kwargs = self._rebuild([Tensor._wrap(d) for d in dyn])
            return _to_raw(self._fn(*args, **kwargs))
        finally:
            for t, o in zip(self._state, old):
                t._t = o


def _export(module, state, dyn):
    """``torch.export`` of ``module(state, *dyn)`` without a tape."""
    with torch.no_grad():
        return torch.export.export(module, (tuple(state), *dyn),
                                   strict=False)


def count_custom_ops(program) -> Dict[str, int]:
    """The port's kernel custom ops among a captured program's nodes (an
    ``ExportedProgram`` or a ``to_static`` function's newest capture),
    by op name."""
    if isinstance(program, StaticFunction):
        program = program.program()
    out: Dict[str, int] = {}
    for node in program.graph_module.graph.nodes:
        t = getattr(node, "target", None)
        name = getattr(t, "name", lambda: "")() if callable(
            getattr(t, "name", None)) else ""
        if node.op == "call_function" and name.startswith(
                "paddle_tpu_torch::"):
            op = name.split("::", 1)[1].split(".")[0]
            out[op] = out.get(op, 0) + 1
    return out


class StaticFunction:
    """A captured-and-replayed callable with a per-signature cache (the
    reference's ``StaticFunction``, ``jax.jit`` replaced by
    ``torch.export``).  A bound method of a ``Layer`` takes the layer's
    parameters and buffers as inputs of every capture, so later updates
    of them are seen without a new capture."""

    def __init__(self, fn, input_spec=None, build_strategy=None,
                 backend=None, donate_argnums=(), lint=False):
        if lint:
            raise NotImplementedError(f"to_static(lint=True): {_ITEM8}")
        self._fn = fn
        functools.update_wrapper(self, fn)
        if not getattr(fn, "_not_to_static", False):
            # dy2static: Python if/while on tensor predicates become
            # torch.cond / while_loop through runtime dispatch helpers;
            # convert_to_static returns fn unchanged on its documented
            # fallback cases, and a real exception is a converter bug:
            # warn and keep the unconverted function
            try:
                from .dy2static import convert_to_static
                fn = convert_to_static(fn)
            except Exception as e:  # pragma: no cover - converter bug
                warnings.warn(
                    f"dy2static conversion failed for "
                    f"{getattr(fn, '__qualname__', fn)}: {e!r}; "
                    "falling back to plain capture")
        self._converted_fn = fn
        self._layer = _layer_of(self._fn)
        # LRU-bounded: keyed by static-leaf values, so a per-call Python
        # scalar would otherwise keep a capture per value forever
        self._cache: "OrderedDict[Any, Dict]" = OrderedDict()
        self._cache_cap = int(os.environ.get("PADDLE_TPU_JIT_CACHE_SIZE",
                                             "128"))
        self._cache_warned = False
        self._trace_name = getattr(fn, "__qualname__",
                                   getattr(fn, "__name__", repr(fn)))
        self._last = None

    def __call__(self, *args, **kwargs):
        """Trace the tensor leaves, bake every other leaf.  With the
        translator off (``jit.enable_to_static(False)``) the original
        function runs eagerly."""
        if not _TO_STATIC_ENABLED[0]:
            return self._fn(*args, **kwargs)
        flat, treedef = pytree.tree_flatten((args, kwargs))
        dyn_idx = tuple(i for i, leaf in enumerate(flat)
                        if _is_dynamic_leaf(leaf))
        dyn_set = set(dyn_idx)
        # type(leaf) in the key: True / 1 / 1.0 compare equal but must
        # not share a capture
        static_leaves = tuple((i, type(leaf), leaf)
                              for i, leaf in enumerate(flat)
                              if i not in dyn_set)
        try:
            key = (str(treedef), dyn_idx,
                   tuple((i, t) for i, t, _ in static_leaves),
                   tuple(leaf for _, _, leaf in static_leaves))
            hash(key)
        except TypeError:
            key = None          # an unhashable static leaf: no caching
        entry = self._cache.get(key) if key is not None else None
        if entry is None:
            entry = {}
            if key is not None:
                self._cache[key] = entry
                if len(self._cache) > self._cache_cap:
                    self._cache.popitem(last=False)
                    if not self._cache_warned:
                        self._cache_warned = True
                        warnings.warn(
                            f"to_static cache for {self._trace_name} "
                            f"exceeded {self._cache_cap} entries and is "
                            "evicting (LRU). A python scalar arg that "
                            "changes every call recaptures every call -- "
                            "pass it as a Tensor, or raise "
                            "PADDLE_TPU_JIT_CACHE_SIZE.")
        else:
            self._cache.move_to_end(key)
        dyn = [_dyn_tensor(flat[i], self._layer) for i in dyn_idx]
        shape_sig = tuple((tuple(t.shape), str(t.dtype), str(t.device))
                          for t in dyn)
        prog = entry.get(shape_sig)
        new_sig = prog is None
        if new_sig:
            from ..profiler import compile_tracker
            compile_tracker.record_trace(self._trace_name)
            # hang injection + the watchdog's compile phase for the
            # capture this new signature pays
            from ..testing.chaos import chaos_point
            chaos_point("jit.compile")
        state = [t._t for t in _state_of(self._layer)]
        from ..runtime import watchdog as _watchdog
        with (_watchdog.phase("compile") if new_sig else nullcontext()):
            if prog is None:
                prog = self._capture(flat, treedef, dyn_idx, state, dyn)
                entry[shape_sig] = prog
            self._last = prog
            with torch.no_grad():
                if new_sig:
                    # FLAGS_tpu_xmem: the new signature's first replay is
                    # profiled (bytes, peak, FLOPs), as the reference
                    # profiles its one compile; otherwise a plain call
                    from ..profiler import xmem
                    out, _ = xmem.capture("to_static", self._trace_name,
                                          prog["module"], tuple(state),
                                          *dyn, sig=shape_sig)
                else:
                    out = prog["module"](tuple(state), *dyn)
        from ..profiler import numerics as _numerics
        if _numerics.enabled():
            self._check_numerics_out(out, args, kwargs)
        return _to_facade(out)

    def _capture(self, flat, treedef, dyn_idx, state, dyn):
        n = len(flat)
        statics = {i: leaf for i, leaf in enumerate(flat)
                   if i not in set(dyn_idx)}

        def rebuild(dyn_tensors):
            full = [None] * n
            for i, v in statics.items():
                full[i] = v
            for i, t in zip(dyn_idx, dyn_tensors):
                full[i] = t
            return pytree.tree_unflatten(full, treedef)

        module = _Capture(self._converted_fn, _state_of(self._layer),
                          rebuild)
        ep = _export(module, state, dyn)
        return {"program": ep, "module": ep.module()}

    def program(self):
        """The newest capture's ``ExportedProgram``."""
        if self._last is None:
            raise RuntimeError(f"{self._trace_name} has not been called")
        return self._last["program"]

    def _check_numerics_out(self, out, args, kwargs):
        """Scan the call's outputs for NaN/Inf; on a finding, localize
        the first bad op by rerunning the function eagerly on the same
        inputs (``numerics.localize``), and fire the tensor checker's
        action."""
        from ..profiler import numerics as _numerics
        site = f"to_static:{self._trace_name}"
        summary = _numerics._tree_summary(out)
        _numerics.record_site(site, summary is not None, summary)
        if summary is None:
            return
        from ..amp.debugging import _default_action
        report = None
        try:
            report = _numerics.localize(self._fn, *args, **kwargs)
        except (TypeError, ValueError, RuntimeError, KeyError,
                AttributeError):
            report = None
        _numerics._dispatch(site, summary, _default_action(),
                            report=report)

    @property
    def concrete_program(self):
        return self.program()

    def rollback(self):
        return self._fn


def _dyn_tensor(leaf, layer):
    if isinstance(leaf, Tensor):
        return leaf._t
    if torch.is_tensor(leaf):
        return leaf
    # a numpy leaf goes to the layer's device, else the current place
    state = _state_of(layer)
    if state:
        dev = state[0]._t.device
    else:
        from ..core.place import current_device
        dev = current_device()
    return torch.as_tensor(np.asarray(leaf)).to(dev)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, lint=False, **kwargs):
    """@paddle.jit.to_static (reference: jit/api.py:222).  ``lint=True``
    waits for ROADMAP A item 8 and raises."""

    def decorate(fn_or_layer):
        from ..nn.layer.layers import Layer
        if isinstance(fn_or_layer, Layer):
            layer = fn_or_layer
            layer.forward = StaticFunction(layer.forward, input_spec,
                                           lint=lint)
            return layer
        return StaticFunction(fn_or_layer, input_spec, lint=lint)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


class TracedLayer:
    """Legacy dygraph-trace API (reference: fluid/dygraph/jit.py)."""

    def __init__(self, fn):
        self._fn = fn

    @staticmethod
    def trace(layer, inputs):
        sf = StaticFunction(layer.forward)
        outs = layer(*inputs)
        return outs, TracedLayer(sf)

    def __call__(self, inputs):
        return self._fn(*inputs)


# ---------------------------------------------------------------------------
# jit.save / jit.load
# ---------------------------------------------------------------------------

def _specs(input_spec):
    if input_spec is None:
        raise ValueError("jit.save requires input_spec for AOT export")
    return [s if isinstance(s, InputSpec) else InputSpec(**s)
            for s in input_spec]


def _placeholders(specs, device):
    return [torch.zeros([1 if d in (-1, None) else int(d) for d in s.shape],
                        dtype=s.dtype, device=device) for s in specs]


def _write(path, ep, state_names, state, specs):
    """``.pdmodel`` (the graph, without example inputs or weights),
    ``.pdiparams`` (the state by name) and ``.meta``."""
    from ..framework.io import save as fsave
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ep._example_inputs = None      # they would hold the weights again
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    fsave({k: Tensor._wrap(v.detach()) for k, v in zip(state_names, state)},
          path + ".pdiparams")
    with open(path + ".meta", "wb") as f:
        pickle.dump({"input_specs": [(list(s.shape),
                                      dtype_mod.dtype_name(s.dtype))
                                     for s in specs],
                     "state_names": list(state_names)}, f)


def save(layer, path, input_spec=None, **configs):
    """Serialize a Layer (or a function / StaticFunction) for serving
    (reference: jit/api.py:773): ``path + '.pdmodel'`` (the captured
    graph), ``'.pdiparams'`` (the weights), ``'.meta'``."""
    from ..nn.layer.layers import Layer
    specs = _specs(input_spec)
    if isinstance(layer, Layer):
        layer.eval()
        names = [k for k, _ in layer.named_parameters()] + \
            [k for k, _ in layer.named_buffers()]
        tensors = _state_of(layer)
        forward = layer.forward
        fn = getattr(forward, "_converted_fn", None) or forward
        dev = tensors[0]._t.device if tensors else None
    elif callable(layer):
        fn = getattr(layer, "_converted_fn", None) or \
            getattr(layer, "__wrapped__", None) or layer
        names, tensors = [], []
        dev = None
    else:
        raise TypeError("jit.save expects a Layer or callable")
    if dev is None:
        from ..core.place import current_device
        dev = current_device()
    dyn = _placeholders(specs, dev)
    module = _Capture(fn, tensors, lambda ts: (tuple(ts), {}))
    state = [t._t for t in tensors]
    ep = _export(module, state, dyn)
    _write(path, ep, names, state, specs)


class TranslatedLayer:
    """A loaded serving artifact (reference: jit/translated_layer.py):
    the graph and its state on the current device."""

    def __init__(self, module, params, names):
        self._module = module
        self._params = params
        self._names = names

    def __call__(self, *args):
        dev = self._params[0].device if self._params else None
        xs = []
        for a in args:
            t = a._t if isinstance(a, Tensor) else torch.as_tensor(
                np.asarray(a))
            xs.append(t.to(dev) if dev is not None else t)
        with torch.no_grad():
            out = self._module(tuple(self._params), *xs)
        return _to_facade(out)

    forward = __call__

    def eval(self):
        return self

    def state_dict(self):
        return {k: Tensor._wrap(v) for k, v in zip(self._names,
                                                   self._params)}


def load(path, device=None, **configs):
    """Load ``jit.save``'s artifact onto ``device``; without one, onto
    the current device (the card unless ``paddle.set_device`` named
    another place)."""
    from ..framework.io import load as fload
    from ..core.place import current_device
    # the custom ops must be registered before the graph deserializes
    from ..ops import flash_attention, fused_blocks  # noqa: F401
    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)
    with open(path + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    dev = torch.device(device) if device is not None else current_device()
    state = fload(path + ".pdiparams")
    names = meta.get("state_names", list(state))
    params = [_raw_tensor(state[k]).to(dev) for k in names]
    return TranslatedLayer(ep.module(), params, names)


def _raw_tensor(v):
    return v._t if isinstance(v, Tensor) else torch.as_tensor(v)


# -- translator global switches (reference: jit/api.py enable_to_static,
# dy2static logging_utils set_verbosity / set_code_level) -----------------

_TO_STATIC_ENABLED = [True]


def enable_to_static(enable_to_static_bool=True):
    """Globally toggle @to_static: when False every StaticFunction runs
    its original Python body eagerly (the reference's
    ProgramTranslator().enable)."""
    _TO_STATIC_ENABLED[0] = bool(enable_to_static_bool)


def set_verbosity(level=0, also_to_stdout=False):
    """dy2static transform logging verbosity."""
    from . import dy2static
    dy2static._VERBOSITY[0] = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """Print the dy2static-rewritten source of converted functions
    (reference: set_code_level)."""
    from . import dy2static
    dy2static._CODE_LEVEL[0] = int(level)
