"""The op registry of the eager core (the port of
``paddle_tpu/ops/registry.py``).

``OP_LIBRARY`` maps each public op's name to its ``Tensor``-level
function and its torch-level lowering; it is the op surface the tests
and ``chip_smoke.py`` sweep.  ``unary_op`` / ``binary_op`` build and
register the elementwise ops from a torch function.  A binary op first
casts both operands to their common dtype (``torch.promote_types``):
that is JAX's rule for two arrays, where torch's own would let a 0-d
operand keep the other's dtype (``bf16 * to_tensor(2.0)`` is float32 in
both packages).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.tensor import Tensor, apply_op, to_tensor

__all__ = ["OP_LIBRARY", "OpInfo", "register", "get_op", "list_ops",
           "unary_op", "binary_op"]


class OpInfo(NamedTuple):
    name: str
    fn: Callable          # the public Tensor-level API
    lowering: Callable    # the torch-level implementation


OP_LIBRARY: Dict[str, OpInfo] = {}


def register(name: str, fn: Callable, lowering: Optional[Callable] = None):
    OP_LIBRARY[name] = OpInfo(name, fn, lowering or fn)
    return fn


def get_op(name: str) -> OpInfo:
    if name not in OP_LIBRARY:
        raise KeyError(f"op '{name}' not registered; have {len(OP_LIBRARY)} ops")
    return OP_LIBRARY[name]


def list_ops():
    return sorted(OP_LIBRARY)


def _ensure_tensor(x):
    if isinstance(x, Tensor):
        return x
    return to_tensor(x)


def promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their common dtype (JAX's rule for two arrays)."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def unary_op(name: str, tfn: Callable, doc: str = ""):
    """Build and register a Tensor-level unary elementwise op."""
    def op(x, name=None):  # noqa: A002 - paddle APIs take a `name` kwarg
        return apply_op(tfn, _ensure_tensor(x), op_name=name or op.__name__)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise {name}."
    register(name, op, tfn)
    return op


def binary_op(name: str, tfn: Callable, doc: str = ""):
    def lowering(a, b):
        return tfn(*promote(a, b))

    def op(x, y, name=None):  # noqa: A002
        return apply_op(lowering, _ensure_tensor(x), _ensure_tensor(y),
                        op_name=name or op.__name__)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise {name} with numpy broadcasting."
    register(name, op, lowering)
    return op
