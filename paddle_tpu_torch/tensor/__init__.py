"""The tensor op surface, installed as ``Tensor`` methods and operators
(the port of ``paddle_tpu/tensor/__init__.py``)."""
from __future__ import annotations

import torch

from ..core.tensor import (Tensor, to_tensor, apply_op, is_grad_enabled,
                           rebind_inplace, tape_snapshot)
from . import creation, math, logic, manipulation, linalg, search, random, \
    attribute, einsum as einsum_mod, extras
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .attribute import shape, rank  # noqa: F401
from .einsum import einsum  # noqa: F401

from .math import (add, subtract, multiply, divide, floor_divide, mod, pow,
                   neg, abs)  # noqa: A004
from .logic import (equal, not_equal, greater_than, greater_equal, less_than,
                    less_equal)
from .manipulation import cast as _cast_fn

_METHOD_SOURCES = [creation, math, logic, manipulation, linalg, search,
                   random, einsum_mod, extras]

# the op names this package exports (the submodules themselves stay out,
# so ``from .tensor import *`` binds no module name in its importer)
__all__ = sorted({n for m in _METHOD_SOURCES + [attribute]
                  for n in m.__all__} | {"Tensor", "to_tensor", "einsum"})

# ---------------------------------------------------------------------------
# Tensor methods
# ---------------------------------------------------------------------------

# ops whose first arg isn't the tensor / that shouldn't become methods
_SKIP_METHODS = {
    "to_tensor", "zeros", "ones", "full", "empty", "arange", "linspace",
    "logspace", "eye", "meshgrid", "tril_indices", "triu_indices",
    "complex", "create_parameter", "rand", "randn", "randint", "randperm",
    "uniform", "normal", "gaussian", "standard_normal", "scatter_nd",
    "add_n", "multiplex", "broadcast_tensors", "multi_dot", "einsum",
    "searchsorted", "concat", "stack", "where",
    "create_array", "array_write", "array_read", "array_length",
    "broadcast_shape", "create_tensor", "set_printoptions",
}


def _install_methods():
    for modsrc in _METHOD_SOURCES:
        for name in getattr(modsrc, "__all__", []):
            if name in _SKIP_METHODS:
                continue
            fn = getattr(modsrc, name)
            if callable(fn) and not hasattr(Tensor, name):
                setattr(Tensor, name, fn)
    Tensor.astype = lambda self, dtype: _cast_fn(self, dtype)
    Tensor.cast = _cast_fn
    Tensor.dim = lambda self: self.ndim
    Tensor.numel = lambda self: manipulation.numel(self)
    Tensor.dot = linalg.dot
    Tensor.matmul = linalg.matmul
    Tensor.mm = linalg.matmul
    Tensor.norm = linalg.norm
    Tensor.where = lambda self, x, y: manipulation.where(self, x, y)
    # one semantics for paddle.add_(x, y) and x.add_(y)
    Tensor.add_ = extras.add_
    Tensor.subtract_ = extras.subtract_
    Tensor.multiply_ = extras.multiply_
    Tensor.scale_ = extras.scale_
    Tensor.zero_ = extras.zero_
    Tensor.fill_ = extras.fill_
    Tensor.clip_ = extras.clip_
    Tensor.exponential_ = random.exponential_
    Tensor.uniform_ = random.uniform_
    Tensor.normal_ = random.normal_
    Tensor.scatter_ = manipulation.scatter_
    Tensor.reshape_ = manipulation.reshape_
    Tensor.fill_diagonal_ = manipulation.fill_diagonal_
    Tensor.unbind = manipulation.unbind
    Tensor.cpu = lambda self: self.to("cpu")
    Tensor.cuda = lambda self, device_id=None: self.to(
        "gpu" if device_id is None else f"gpu:{device_id}")
    Tensor.pin_memory = lambda self: self
    Tensor.contiguous = lambda self: apply_op(
        lambda a: a.contiguous(), self, op_name="contiguous")
    Tensor.is_contiguous = lambda self: self._t.is_contiguous()


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _binop(fn, reverse=False):
    def method(self, other):
        if reverse:
            return fn(to_tensor(other) if not isinstance(other, Tensor)
                      else other, self)
        return fn(self, other)
    return method


def _and(x, y):
    if x.dtype == torch.bool:
        return logic.logical_and(x, y)
    return math.bitwise_and(x, y)


def _or(x, y):
    if x.dtype == torch.bool:
        return logic.logical_or(x, y)
    return math.bitwise_or(x, y)


def _xor(x, y):
    if x.dtype == torch.bool:
        return logic.logical_xor(x, y)
    return math.bitwise_xor(x, y)


def _idx_conv(item):
    if isinstance(item, Tensor):
        return item._t
    if isinstance(item, tuple):
        return tuple(_idx_conv(i) for i in item)
    return item


def _getitem(self, item):
    idx = _idx_conv(item)
    return apply_op(lambda a: a[idx], self, op_name="getitem")


def _set(a, idx, v):
    out = a.clone()
    out[idx] = v.to(a.dtype) if torch.is_tensor(v) else v
    return out


def _setitem(self, item, value):
    idx = _idx_conv(item)
    v_is_t = isinstance(value, Tensor)
    needs_grad = is_grad_enabled() and (
        not self.stop_gradient or (v_is_t and not value.stop_gradient))
    if not needs_grad:
        v = value._t if v_is_t else value
        with torch.no_grad():
            self._set_array(_set(self._t.detach(), idx, v))
        return
    # an in-place op: cotangents flow to the old value (zeros at the
    # overwritten slots) and to `value` (gathered)
    snap = tape_snapshot(self)
    if v_is_t:
        out = apply_op(lambda a, v: _set(a, idx, v), snap, value,
                       op_name="setitem")
    else:
        out = apply_op(lambda a: _set(a, idx, value), snap,
                       op_name="setitem")
    rebind_inplace(self, out)


def _install_operators():
    Tensor.__add__ = _binop(add)
    Tensor.__radd__ = _binop(add, reverse=True)
    Tensor.__sub__ = _binop(subtract)
    Tensor.__rsub__ = _binop(subtract, reverse=True)
    Tensor.__mul__ = _binop(multiply)
    Tensor.__rmul__ = _binop(multiply, reverse=True)
    Tensor.__truediv__ = _binop(divide)
    Tensor.__rtruediv__ = _binop(divide, reverse=True)
    Tensor.__floordiv__ = _binop(floor_divide)
    Tensor.__rfloordiv__ = _binop(floor_divide, reverse=True)
    Tensor.__mod__ = _binop(mod)
    Tensor.__rmod__ = _binop(mod, reverse=True)
    Tensor.__pow__ = _binop(pow)
    Tensor.__rpow__ = _binop(pow, reverse=True)
    Tensor.__matmul__ = _binop(linalg.matmul)
    Tensor.__rmatmul__ = _binop(linalg.matmul, reverse=True)
    Tensor.__neg__ = lambda self: neg(self)
    Tensor.__abs__ = lambda self: abs(self)
    Tensor.__eq__ = _binop(equal)
    Tensor.__ne__ = _binop(not_equal)
    Tensor.__lt__ = _binop(less_than)
    Tensor.__le__ = _binop(less_equal)
    Tensor.__gt__ = _binop(greater_than)
    Tensor.__ge__ = _binop(greater_equal)
    Tensor.__invert__ = lambda self: logic.logical_not(self)
    Tensor.__and__ = _binop(_and)
    Tensor.__or__ = _binop(_or)
    Tensor.__xor__ = _binop(_xor)
    Tensor.__getitem__ = _getitem
    Tensor.__setitem__ = _setitem


_install_methods()
_install_operators()
