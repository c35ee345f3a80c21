"""Numerics: the NaN/Inf watchdog and first-bad-op localization (the port
of ``paddle_tpu/profiler/numerics.py``).

1. **Check sites**: ``check_array``/``check_tree`` count NaN and Inf in
   concrete arrays (torch tensors or numpy) at a named site, with an
   action (warn, raise, collect); ``sites()`` holds the counts.  Gated
   by ``FLAGS_tpu_check_nan_inf``: off, a site is one dict lookup.
2. **Localization**: ``localize(fn, *args)`` runs ``fn`` under a
   ``TorchDispatchMode`` that checks every floating output of every
   aten operation and reports the first one that turned finite inputs
   into non-finite values, with the Python frame that called it.  The
   reference re-interprets a jaxpr; the port has none.  The port's CUDA
   kernels run through ctypes, outside the dispatcher, so each kernel
   wrapper runs its work through ``opaque``: while a localization is
   active the call is checked as one operation under the wrapper's name
   (its inner aten operations, the plain version's on the CPU, are not
   checked one by one), and a value born in ``fused_qkv`` is blamed on
   ``fused_qkv``, not on the next aten operation.
3. **Stats**: ``note(name, value)`` keeps the last value of named
   scalars (quantization errors, losses) for the Profiler's "Numerics"
   section.
"""
from __future__ import annotations

import math
import os
import sys
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import flags as _flags

__all__ = ["enabled", "check_array", "check_tree", "localize", "watch",
           "opaque", "record_site", "sites", "note", "last_stats",
           "collected", "clear_collected", "reset", "summary_lines",
           "NonFiniteError"]

_FLAG_DICT = _flags._REGISTRY
_FLAG_NAME = "FLAGS_tpu_check_nan_inf"


def enabled() -> bool:
    """Whether the numerics watchdog is on (the only check hot paths pay)."""
    return bool(_FLAG_DICT.get(_FLAG_NAME, False))


class NonFiniteError(FloatingPointError):
    """Raised by a check site with action='raise'; ``.report`` holds the
    localization when one ran."""

    def __init__(self, msg, report=None):
        super().__init__(msg)
        self.report = report


# ---------------------------------------------------------------------------
# site registry + last-value stats + collect buffer
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_SITES: Dict[str, Dict[str, Any]] = {}
_LAST: Dict[str, float] = {}
_COLLECTED: List[dict] = []
_COLLECT_CAP = 10000


def record_site(name: str, nonfinite: bool, summary: Optional[dict] = None):
    """Count a check at ``name``; keep the last non-finite summary."""
    with _LOCK:
        s = _SITES.get(name)
        if s is None:
            s = _SITES[name] = {"hits": 0, "nonfinite": 0, "last": None}
        s["hits"] += 1
        if nonfinite:
            s["nonfinite"] += 1
            if summary is not None:
                s["last"] = summary


def sites() -> Dict[str, Dict[str, Any]]:
    with _LOCK:
        return {k: dict(v) for k, v in _SITES.items()}


def note(name: str, value) -> None:
    """Record the last value of a named numerics stat."""
    try:
        _LAST[name] = float(value)
    except (TypeError, ValueError):
        pass


def last_stats() -> Dict[str, float]:
    return dict(_LAST)


def collected() -> List[dict]:
    """Findings of action='collect' sites, oldest first."""
    with _LOCK:
        return list(_COLLECTED)


def clear_collected():
    with _LOCK:
        _COLLECTED.clear()


def reset():
    with _LOCK:
        _SITES.clear()
        _LAST.clear()
        _COLLECTED.clear()


# ---------------------------------------------------------------------------
# host-side checking
# ---------------------------------------------------------------------------

def _is_float(x) -> bool:
    if torch.is_tensor(x):
        return x.is_floating_point()
    dt = getattr(x, "dtype", None)
    return dt is not None and np.issubdtype(np.dtype(dt), np.floating)


def _summarize_array(arr) -> Optional[dict]:
    """NaN and Inf counts of a concrete array; None when it is finite or
    not floating."""
    if torch.is_tensor(arr):
        if not arr.is_floating_point():
            return None
        t = arr.detach()
        finite = torch.isfinite(t)
        if bool(finite.all()):
            return None
        nan = int(torch.isnan(t).sum())
        inf = int((~finite).sum()) - nan
        dtype = str(t.dtype).replace("torch.", "")
        return {"nan": nan, "inf": inf, "size": int(t.numel()),
                "shape": list(t.shape), "dtype": dtype}
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.floating):
        return None
    finite = np.isfinite(a)
    if bool(finite.all()):
        return None
    nan = int(np.isnan(a).sum())
    inf = int((~finite).sum()) - nan
    return {"nan": nan, "inf": inf, "size": int(a.size),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def _dispatch(name, summary, action, report=None):
    msg = (f"numerics: non-finite values in {name!r}: "
           f"{summary['nan']} NaN, {summary['inf']} Inf out of "
           f"{summary['size']} ({summary['dtype']}{summary['shape']})")
    if report is not None:
        msg += f"; first bad op: {report.get('where', '?')}"
    if action == "raise":
        raise NonFiniteError(msg, report=report)
    if action == "collect":
        with _LOCK:
            if len(_COLLECTED) < _COLLECT_CAP:
                _COLLECTED.append({"name": name, **summary,
                                   "report": report})
        return
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def check_array(arr, name: str, action: str = "warn") -> bool:
    """Check one concrete array at the site ``name``: True when it holds
    non-finite values (action='raise' raises ``NonFiniteError``
    instead).  One dict lookup when the flag is off."""
    if not enabled():
        return False
    summary = _summarize_array(arr)
    record_site(name, summary is not None, summary)
    if summary is None:
        return False
    _dispatch(name, summary, action)
    return True


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def check_tree(tree, name: str, action: str = "warn") -> bool:
    """``check_array`` over every floating leaf of a nested structure
    (dicts in key order, as jax's tree flattening orders them)."""
    if not enabled():
        return False
    leaves = _leaves(tree)
    found = False
    for i, arr in enumerate(leaves):
        if not hasattr(arr, "dtype"):
            continue
        found = check_array(arr, f"{name}[{i}]" if len(leaves) > 1
                            else name, action) or found
    return found


# ---------------------------------------------------------------------------
# first-bad-op localization
# ---------------------------------------------------------------------------

_HERE = os.path.abspath(__file__)
# frames a report looks past: torch's own and the context managers'
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)),
         os.path.abspath(__import__("contextlib").__file__))

# the localizations running on this process, innermost last
_ACTIVE: List["_Localizer"] = []


def _user_frame():
    """(file, line, function) of the nearest caller outside torch and
    this module."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn != _HERE and not fn.startswith(_SKIP):
            return fn, f.f_lineno, f.f_code.co_name
        f = f.f_back
    return None, None, None


def _first_nonfinite(vals):
    for i, v in enumerate(vals):
        if _is_float(v):
            s = _summarize_array(v)
            if s is not None:
                return i, s
    return None


def _tensor_leaves(tree):
    return [x for x in _leaves(tree) if torch.is_tensor(x)]


class _Localizer:
    """The state of one ``localize`` run: the first report, the calls
    counted by op name (``call_index``: the layer of a kernel launched
    once a layer), and how deep inside an opaque kernel call it is."""

    def __init__(self):
        self.report: Optional[dict] = None
        self.calls: Dict[str, int] = {}
        self.depth = 0
        self.index = 0

    def seen(self, op: str, inputs, outputs, kind: str):
        n = self.calls.get(op, 0)
        self.calls[op] = n + 1
        self.index += 1
        if self.report is not None:
            return
        bad = _first_nonfinite(outputs)
        if bad is None or _first_nonfinite(inputs) is not None:
            # blame the op that introduced the values, not the ones that
            # carry them on
            return
        out_i, summary = bad
        file_name, line, func = _user_frame()
        where = (f"{file_name}:{line} ({func})" if file_name
                 else "<unknown>")
        self.report = {"primitive": op, "kind": kind, "where": where,
                       "file": file_name, "line": line, "function": func,
                       "call_index": n, "op_index": self.index - 1,
                       "path": op, "output_index": out_i, **summary}

    def opaque(self, name: str, fn, args, kwargs):
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        if self.depth == 0:
            self.seen(name, _tensor_leaves((args, kwargs)),
                      _tensor_leaves(out), "kernel")
        return out


def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, loc: _Localizer):
            super().__init__()
            self.loc = loc

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            loc = self.loc
            if loc.depth == 0:
                loc.seen(str(func), _tensor_leaves((args, kwargs)),
                         _tensor_leaves(out), "aten")
            return out
    return _Mode


def opaque(name: str, fn: Callable, *args, **kwargs):
    """Run a kernel wrapper's work, ``fn(*args, **kwargs)``.  Outside a
    localization that is all it does; inside one the call is checked as
    one operation named ``name``."""
    if not _ACTIVE:
        return fn(*args, **kwargs)
    return _ACTIVE[-1].opaque(name, fn, args, kwargs)


def localize(fn: Callable, *args, **kwargs) -> Optional[dict]:
    """The first operation of ``fn(*args, **kwargs)`` whose output goes
    non-finite from finite inputs: a report (``primitive``: the aten
    overload or the kernel wrapper's name; ``kind``: "aten" or
    "kernel"; ``where``/``file``/``line``/``function``: the Python frame
    that called it; ``call_index``: how many calls of that op came
    before; NaN/Inf counts), or None when every value stays finite.
    Non-finite inputs are reported as ``{"primitive": "<input>"}``: no
    op is to blame.  Slow (every output is checked on the host): run it
    after a watchdog tripped, not in the loop."""
    ins = _tensor_leaves((args, kwargs))
    bad_in = _first_nonfinite(ins)
    if bad_in is not None:
        i, summary = bad_in
        return {"primitive": "<input>", "kind": "input",
                "where": f"input[{i}]", "file": None, "line": None,
                "function": None, "call_index": -1, "op_index": -1,
                "path": "<input>", "output_index": i, **summary}
    loc = _Localizer()
    _ACTIVE.append(loc)
    try:
        with _mode_class()(loc):
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(loc)
    return loc.report


def watch(fn: Callable, name: Optional[str] = None,
          action: str = "raise") -> Callable:
    """``fn`` with its outputs checked after every call; on non-finite
    outputs ``localize`` reruns it to name the first bad op, and the
    action fires with the report attached.  Flag off: one dict lookup a
    call."""
    import functools

    site = name or getattr(fn, "__qualname__",
                           getattr(fn, "__name__", "watched"))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not enabled():
            return out
        summary = _tree_summary(out)
        record_site(site, summary is not None, summary)
        if summary is not None:
            report = None
            try:
                report = localize(fn, *args, **kwargs)
            except (TypeError, ValueError, RuntimeError, KeyError,
                    AttributeError) as e:
                import logging
                logging.getLogger(__name__).debug(
                    "numerics localization failed at %s: %s", site, e)
            _dispatch(site, summary, action, report=report)
        return out

    return wrapper


def _tree_summary(tree) -> Optional[dict]:
    for arr in _leaves(tree):
        if not hasattr(arr, "dtype") or not _is_float(arr):
            continue
        s = _summarize_array(arr)
        if s is not None:
            return s
    return None


# ---------------------------------------------------------------------------
# Profiler "Numerics" section
# ---------------------------------------------------------------------------

_STAT_ORDER = ("grad_global_norm", "grad_global_norm_preclip",
               "grad_global_norm_postclip", "param_global_norm",
               "weight_update_ratio", "loss_scale", "train_loss")


def summary_lines() -> List[str]:
    lines = [f"Numerics  (FLAGS_tpu_check_nan_inf="
             f"{'on' if enabled() else 'off'})"]
    with _LOCK:
        site_items = sorted(_SITES.items())
        stats = dict(_LAST)
        n_collected = len(_COLLECTED)
    # the quantization-error gauges (quant_err_*) group under their own
    # block, so a bad scale is localized like a NaN
    quant = [k for k in sorted(stats) if k.startswith("quant_err_")]
    shown = [k for k in _STAT_ORDER if k in stats]
    shown += [k for k in sorted(stats)
              if k not in _STAT_ORDER and k not in quant]
    for k in shown:
        v = stats[k]
        mark = "  <-- NON-FINITE" if not math.isfinite(v) else ""
        lines.append(f"  {k:<28} {v:.6g}{mark}")
    if quant:
        lines.append("  Quantization")
        for k in quant:
            v = stats[k]
            mark = "  <-- NON-FINITE" if not math.isfinite(v) else ""
            lines.append(f"    {k:<28} {v:.6g}{mark}")
    if site_items:
        lines.append(f"  check sites: {len(site_items)}")
        for nm, s in site_items[:10]:
            mark = "  <-- NON-FINITE" if s["nonfinite"] else ""
            lines.append(f"    {nm[:44]:<44} {s['hits']:>7} hits "
                         f"{s['nonfinite']:>5} bad{mark}")
    if n_collected:
        lines.append(f"  collected findings: {n_collected} "
                     f"(numerics.collected())")
    return lines
