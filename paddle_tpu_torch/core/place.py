"""Places: where the eager core creates its tensors.

The port of ``paddle_tpu/core/place.py``.  A ``Place`` resolves to a
``torch.device``; ``CUDAPlace`` stands where the reference has
``TPUPlace``.  ``set_device("gpu" | "gpu:N" | "cpu")`` sets the current
place, on which every tensor of the eager core is created.  With no
``set_device`` call the current place is the card, through
``device.resolve_device``: with no card, creating a tensor raises and
never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "set_device", "get_device",
           "device_count", "is_compiled_with_cuda", "current_device"]


class Place:
    """A hashable handle that resolves to a ``torch.device``."""

    _kind = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def __repr__(self):
        return f"Place({self._kind}:{self.device_id})"

    def is_cpu_place(self):
        return self._kind == "cpu"

    def is_gpu_place(self):
        return self._kind == "gpu"


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(Place):
    """The card (the reference's ``TPUPlace``)."""

    _kind = "gpu"

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"


_CURRENT = [None]


def place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def _parse_device(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    if isinstance(device, str):
        name = device.lower()
        if name == "cpu":
            return CPUPlace()
        idx = 0
        if ":" in name:
            name, idx_s = name.split(":", 1)
            idx = int(idx_s)
        if name in ("gpu", "cuda"):
            return CUDAPlace(idx)
    raise ValueError(f"Cannot parse device: {device!r}")


def set_device(device) -> Place:
    """paddle.set_device('gpu' | 'gpu:N' | 'cpu')."""
    place = _parse_device(device)
    _CURRENT[0] = place
    return place


def _current_place() -> Place:
    if _CURRENT[0] is None:
        return place_of(resolve_device(None))
    return _CURRENT[0]


def current_device() -> torch.device:
    """The ``torch.device`` of the current place: the card unless
    ``set_device`` named another; with neither, this raises."""
    return _current_place().device


def get_device() -> str:
    p = _current_place()
    if p.is_cpu_place():
        return "cpu"
    return f"gpu:{p.device_id}"


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count()
