"""Memory and cost of one call (the port of ``paddle_tpu/profiler/xmem.py``).

The reference reads each XLA executable's ``memory_analysis()`` and
``cost_analysis()``.  The port has no executables: ``capture`` runs one
call and reads the CUDA caching allocator around it
(``reset_peak_memory_stats`` before, ``max_memory_allocated`` after) and
counts its aten operations' FLOPs with
``torch.utils.flop_counter.FlopCounterMode``.  The FLOPs of the port's
own kernels, which run outside the dispatcher, are not in that count.  Besides the captured calls the store keeps each CUDA kernel's
shared memory and registers as ptxas reports them
(``record_kernel_estimate``) and the long-lived reservations that no one
call shows, the serving engine's KV pools (``record_reservation``).

Capture runs the call under a dispatch mode and restarts the card's
peak counter, so it runs only under ``FLAGS_tpu_xmem``; the records,
which cost nothing, also under ``FLAGS_tpu_metrics``, whose ``xmem_*``
gauges they feed.  Off, each entry point is one dict lookup.  ``summary_lines()`` is the Profiler's "Memory" section and
``device.memory_stats`` merges the captured peaks with the allocator's
counters.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from .. import flags as _flags
from . import metrics as _metrics

__all__ = ["enabled", "capturing", "enable", "disable", "capture",
           "profiles", "stats", "reset", "max_static_peak", "summary_lines",
           "record_kernel_estimate", "kernel_estimates",
           "record_reservation", "reservations"]

_FLAG_DICT = _flags._REGISTRY
_FLAG_NAME = "FLAGS_tpu_xmem"

_lock = threading.Lock()
# (source, name, sig) -> profile; LRU-bounded
_STORE: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
_STORE_CAP = int(os.environ.get("PADDLE_TPU_XMEM_CAP", "256"))


def enabled() -> bool:
    """The records (kernel estimates, reservations) are kept when
    FLAGS_tpu_xmem is set, or whenever the metrics registry is on (the
    numbers must reach the exporter)."""
    return capturing() or _metrics.enabled()


def capturing() -> bool:
    """``capture`` profiles calls only under FLAGS_tpu_xmem itself: it
    slows the call and restarts the card's peak counter."""
    return bool(_FLAG_DICT.get(_FLAG_NAME, False))


def enable():
    _flags.set_flags({_FLAG_NAME: True})


def disable():
    _flags.set_flags({_FLAG_NAME: False})


def _tensors(tree, out=None):
    out = [] if out is None else out
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif hasattr(tree, "state_tree"):       # the port's optimizers
        _tensors(tree.state_tree(), out)
    return out


def _storages(ts) -> Dict[int, int]:
    """data_ptr -> bytes of each distinct storage."""
    out: Dict[int, int] = {}
    for t in ts:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue
        out[st.data_ptr()] = st.nbytes()
    return out


def capture(source: str, name: str, fn, *args, sig: Any = None, **kwargs):
    """``(fn(*args, **kwargs), profile)``: the call's argument, output
    and temporary bytes, its peak and its FLOPs, stored under
    ``(source, name, sig)``.  The profile is None unless FLAGS_tpu_xmem
    is set (``capturing``).
    ``peak_bytes`` is the call's own footprint, arguments + outputs +
    temporaries - outputs that alias an argument (the reference's
    formula); ``device_peak_bytes`` the allocator's high-water mark over
    the call, everything else on the card included.  On the CPU there is
    no allocator to read: temporaries and the device peak are 0.
    ``flops`` counts the aten operations only: the port's own kernels
    run outside the dispatcher.

    On the card, capture calls ``torch.cuda.reset_peak_memory_stats``:
    a caller's own peak window (``max_memory_allocated``) restarts at
    the captured call.  ``prior_peak_bytes`` keeps that window's peak
    as it stood just before."""
    if not capturing():
        return fn(*args, **kwargs), None
    from torch.utils.flop_counter import FlopCounterMode
    arg_st = _storages(_tensors((args, kwargs)))
    dev = next((t.device for t in _tensors((args, kwargs))
                if t.device.type == "cuda"), None)
    base = prior = 0
    if dev is not None:
        torch.cuda.synchronize(dev)
        prior = int(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    out_st = _storages(_tensors(out))
    alias = sum(b for p, b in out_st.items() if p in arg_st)
    out_bytes = sum(b for p, b in out_st.items() if p not in arg_st)
    dev_peak = temp = 0
    if dev is not None:
        torch.cuda.synchronize(dev)
        dev_peak = int(torch.cuda.max_memory_allocated(dev))
        temp = max(0, dev_peak - base - out_bytes)
    arg_bytes = sum(arg_st.values())
    profile = {
        "source": source, "name": name,
        "sig": repr(sig) if sig is not None else "",
        "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
        "temp_bytes": int(temp), "alias_bytes": int(alias),
        "peak_bytes": int(arg_bytes + out_bytes + temp),
        "device_peak_bytes": dev_peak, "prior_peak_bytes": prior,
        "flops": float(counter.get_total_flops()),
        "device": str(dev) if dev is not None else "cpu",
    }
    key = (source, name, profile["sig"])
    with _lock:
        _STORE[key] = profile
        _STORE.move_to_end(key)
        while len(_STORE) > _STORE_CAP:
            _STORE.popitem(last=False)
    if _metrics.enabled():
        label = (name if not profile["sig"]
                 else f"{name}|{profile['sig']}")[:120]
        _metrics.gauge("xmem_peak_bytes",
                       "Footprint of one captured call (args + outputs + "
                       "temporaries)", fn=label).set(profile["peak_bytes"])
        _metrics.gauge("xmem_temp_bytes",
                       "Temporary bytes of one captured call",
                       fn=label).set(profile["temp_bytes"])
        _metrics.gauge("xmem_flops",
                       "FLOPs of the aten operations of one captured call (the "
                       "port's own kernels not counted)",
                       fn=label).set(profile["flops"])
        _metrics.counter("xmem_captures_total",
                         "Calls captured by the xmem layer").inc()
    return out, profile


def profiles() -> List[Dict[str, Any]]:
    with _lock:
        return [dict(p) for p in _STORE.values()]


def stats() -> Dict[str, Any]:
    """Aggregate snapshot: captured calls, their largest peak, their
    temporaries."""
    with _lock:
        vals = list(_STORE.values())
    return {"executables": len(vals),
            "max_peak_bytes": max((p["peak_bytes"] for p in vals), default=0),
            "max_device_peak_bytes": max((p["device_peak_bytes"]
                                          for p in vals), default=0),
            "total_temp_bytes": sum(p["temp_bytes"] for p in vals),
            "profiles": [dict(p) for p in vals]}


def max_static_peak() -> int:
    """The largest footprint of the captured calls."""
    with _lock:
        return max((p["peak_bytes"] for p in _STORE.values()), default=0)


# ---------------------------------------------------------------------------
# CUDA kernel footprints (shared memory and registers from ptxas)
# ---------------------------------------------------------------------------

_KERNELS: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
_KERNELS_CAP = 256


def record_kernel_estimate(kernel: str, smem_bytes: int, **detail) -> None:
    """One kernel's shared memory per block (and, in ``detail``, its
    ``registers`` per thread), keyed by (kernel, ``where``) so a rebuild
    updates in place.  The reference's argument is the Pallas kernel's
    VMEM estimate; shared memory is what a CUDA block holds on chip."""
    if not enabled():
        return
    entry = {"kernel": kernel, "smem_bytes": int(smem_bytes)}
    entry.update(detail)
    key = (kernel, entry.get("where", ""))
    with _lock:
        _KERNELS[key] = entry
        _KERNELS.move_to_end(key)
        while len(_KERNELS) > _KERNELS_CAP:
            _KERNELS.popitem(last=False)
    if _metrics.enabled():
        _metrics.gauge("xmem_kernel_smem_bytes",
                       "Shared memory per block of a CUDA kernel (ptxas)",
                       kernel=kernel[:120]).set(entry["smem_bytes"])


def kernel_estimates() -> List[Dict[str, Any]]:
    """The recorded kernels, most shared memory first."""
    with _lock:
        vals = [dict(v) for v in _KERNELS.values()]
    vals.sort(key=lambda e: -e["smem_bytes"])
    return vals


# ---------------------------------------------------------------------------
# long-lived reservations (the serving engine's KV pools)
# ---------------------------------------------------------------------------

_RESERVATIONS: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()


def record_reservation(name: str, nbytes: int, **detail) -> None:
    """Record (or update, by name) one long-lived device reservation;
    ``nbytes <= 0`` drops it (the pool was released)."""
    if not enabled():
        return
    with _lock:
        if nbytes <= 0:
            _RESERVATIONS.pop(name, None)
        else:
            entry = {"name": name, "bytes": int(nbytes)}
            entry.update(detail)
            _RESERVATIONS[name] = entry
    if _metrics.enabled():
        _metrics.gauge(
            "xmem_reserved_bytes",
            "Long-lived HBM reservation (paged-KV pools etc.)",
            pool=name[:120]).set(max(int(nbytes), 0))


def reservations() -> List[Dict[str, Any]]:
    """The live reservations, largest first."""
    with _lock:
        vals = [dict(v) for v in _RESERVATIONS.values()]
    vals.sort(key=lambda e: -e["bytes"])
    return vals


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def summary_lines(top: int = 8) -> List[str]:
    """The "Memory" section of ``Profiler.summary_table()``: one row a
    captured call, largest footprint first; the kernels' shared memory;
    the reservations."""
    with _lock:
        vals = sorted(_STORE.values(), key=lambda p: -p["peak_bytes"])
        kernels = sorted(_KERNELS.values(), key=lambda e: -e["smem_bytes"])
    res_lines = [f"  reserved {r['name'][:34]:<34}"
                 f"{_fmt_bytes(r['bytes']):>12}" for r in reservations()]
    lines = ["Memory"]
    if not vals:
        lines.append("  (no calls captured — set FLAGS_tpu_xmem before "
                     "the first step)")
        return lines + _kernel_lines(kernels, top) + res_lines
    lines.append(f"  captured calls: {len(vals)}  (the CUDA caching "
                 f"allocator around one call)")
    lines.append(f"  {'Call':<38}{'Peak':>12}{'DevPeak':>12}{'Temp':>12}"
                 f"{'Args':>12}{'atenFLOPs':>12}")
    for p in vals[:top]:
        label = f"{p['source']}:{p['name']}"
        lines.append(f"  {label[:38]:<38}"
                     f"{_fmt_bytes(p['peak_bytes']):>12}"
                     f"{_fmt_bytes(p['device_peak_bytes']):>12}"
                     f"{_fmt_bytes(p['temp_bytes']):>12}"
                     f"{_fmt_bytes(p['argument_bytes']):>12}"
                     f"{p['flops']:>12.3g}")
    if len(vals) > top:
        lines.append(f"  ... {len(vals) - top} more "
                     f"(xmem.profiles() has all)")
    return lines + _kernel_lines(kernels, top) + res_lines


def _kernel_lines(kernels: List[Dict[str, Any]], top: int) -> List[str]:
    if not kernels:
        return []
    lines = [f"  CUDA kernels: {len(kernels)}  "
             f"(shared memory and registers from ptxas)"]
    for e in kernels[:top]:
        regs = e.get("registers")
        extra = f"  {regs} registers" if regs is not None else ""
        lines.append(f"    {e['kernel'][:36]:<36}"
                     f"{_fmt_bytes(e['smem_bytes']):>12}{extra}")
    return lines


def reset():
    """Drop everything captured (tests, between cases)."""
    with _lock:
        _STORE.clear()
        _KERNELS.clear()
        _RESERVATIONS.clear()
