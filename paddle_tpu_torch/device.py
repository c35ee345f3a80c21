"""Device resolution for every entry point of the port.

The port runs on the card unless the caller names another device.  With
no device given and no card present it raises: it never picks the CPU
on its own, so a run that was meant for the card cannot quietly measure
the CPU instead.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
