"""Device resolution for every entry point of the port.

The port runs on the card unless the caller names another device.  With
no device given and no card present it raises: it never picks the CPU
on its own, so a run that was meant for the card cannot quietly measure
the CPU instead.  ``memory_stats`` is the reference's
``device.memory_stats``: the CUDA caching allocator's counters merged
with the footprints ``profiler.xmem`` captured.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "memory_stats"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def memory_stats(device=None) -> dict:
    """The CUDA caching allocator's counters of ``device`` (the card
    unless the caller names another; the CPU has none) plus:

      bytes_in_use              memory_allocated
      bytes_reserved            memory_reserved
      live_peak_bytes_in_use    max_memory_allocated
      xmem_static_peak_bytes    the largest footprint profiler.xmem
                                captured (args + outputs + temporaries)
      peak_bytes_in_use         the larger of the two peaks
    """
    from .profiler import xmem
    dev = resolve_device(device)
    stats: dict = {}
    if dev.type == "cuda":
        stats = dict(torch.cuda.memory_stats(dev))
        stats["bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
        stats["bytes_reserved"] = int(torch.cuda.memory_reserved(dev))
        live = int(torch.cuda.max_memory_allocated(dev))
    else:
        stats.update(bytes_in_use=0, bytes_reserved=0)
        live = 0
    static = xmem.max_static_peak()
    stats["live_peak_bytes_in_use"] = live
    stats["xmem_static_peak_bytes"] = static
    stats["peak_bytes_in_use"] = max(live, static)
    return stats
