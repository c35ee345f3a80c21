"""Einsum (the port of ``paddle_tpu/tensor/einsum.py``): ``torch.einsum``
plans the contraction."""
from __future__ import annotations

import torch

from ..core.tensor import apply_op
from ..ops.registry import register, _ensure_tensor

__all__ = ["einsum"]


def einsum(equation, *operands):
    tensors = [_ensure_tensor(op) for op in operands]
    def _f(*arrs):
        dt = arrs[0].dtype
        for a in arrs[1:]:
            dt = torch.promote_types(dt, a.dtype)
        return torch.einsum(equation, *[a.to(dt) for a in arrs])
    return apply_op(_f, *tensors, op_name="einsum")


register("einsum", einsum)
