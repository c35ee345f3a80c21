"""Weights across the package boundary: ``paddle_tpu``'s parameter tree,
as numpy arrays, into the port's dict of tensors.

The tree keeps its layout: the stacked ``[L, ...]`` layer leaves stay
stacked, and ``{"q": int8, "scale": f32}`` leaves of a quantized model
stay such dicts.  The two frameworks draw different numbers from the
same seed, so this is the only way the tests give both the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_jax", "params_to"]


def _tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the bits across
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def params_to(tree: Any, device) -> Any:
    """The same nesting of tensors, moved to ``device`` (tensors already
    there are not copied)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
