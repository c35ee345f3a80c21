"""Tensor attribute ops (the port of
``paddle_tpu/tensor/attribute.py``)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..core import dtype as dtype_mod
from ..ops.registry import register, _ensure_tensor

__all__ = ["shape", "rank", "is_floating_point", "is_integer", "is_complex",
           "real", "imag"]


def shape(x):
    x = _ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.shape, dtype=torch.int32,
                                     device=x._t.device))


def rank(x):
    x = _ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.ndim, dtype=torch.int32,
                                     device=x._t.device))


def is_floating_point(x):
    return dtype_mod.is_floating_point(_ensure_tensor(x).dtype)


def is_integer(x):
    return dtype_mod.is_integer(_ensure_tensor(x).dtype)


def is_complex(x):
    return dtype_mod.is_complex(_ensure_tensor(x).dtype)


from .math import real, imag  # noqa: E402  (re-export for paddle parity)

for _n in ["shape", "rank"]:
    register(_n, globals()[_n])
