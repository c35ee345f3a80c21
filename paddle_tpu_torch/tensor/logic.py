"""Comparison and logical ops (the port of
``paddle_tpu/tensor/logic.py``)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import binary_op, unary_op, register, _ensure_tensor, \
    promote

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "isclose", "allclose", "equal_all", "is_empty", "is_tensor",
]

equal = binary_op("equal", torch.eq)
not_equal = binary_op("not_equal", torch.ne)
greater_than = binary_op("greater_than", torch.gt)
greater_equal = binary_op("greater_equal", torch.ge)
less_than = binary_op("less_than", torch.lt)
less_equal = binary_op("less_equal", torch.le)
logical_and = binary_op("logical_and", torch.logical_and)
logical_or = binary_op("logical_or", torch.logical_or)
logical_xor = binary_op("logical_xor", torch.logical_xor)
logical_not = unary_op("logical_not", torch.logical_not)


def _isclose(a, b, rtol, atol, equal_nan):
    a, b = promote(a, b)
    if not (a.is_floating_point() or a.is_complex()):
        a, b = a.double(), b.double()
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: _isclose(a, b, rtol, atol, equal_nan),
                    x, y, op_name="isclose")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: _isclose(a, b, rtol, atol, equal_nan).all(),
                    x, y, op_name="allclose")


def equal_all(x, y, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)

    def _f(a, b):
        if a.shape != b.shape:
            return torch.tensor(False, device=a.device)
        return torch.all(torch.eq(*promote(a, b)))
    return apply_op(_f, x, y, op_name="equal_all")


def is_empty(x, name=None):
    x = _ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.size == 0, device=x._t.device))


def is_tensor(x):
    return isinstance(x, Tensor)


for _n in ["isclose", "allclose", "equal_all", "is_empty"]:
    register(_n, globals()[_n])
