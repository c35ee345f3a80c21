"""The rest of the tensor surface: in-place variants, TensorArray ops
and assorted stragglers (the port of ``paddle_tpu/tensor/extras.py``).

An in-place ``op_(x, ...)`` applies the functional op to a snapshot of
x and rebinds x to the result (``core.tensor.tape_snapshot`` /
``rebind_inplace``), so autograd sees the old value as the op's input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, tape_snapshot, rebind_inplace
from . import linalg as _linalg
from . import manipulation as _manip
from . import math as _math

__all__ = [
    # inplace (scatter_/reshape_/fill_diagonal_ live in manipulation.py,
    # uniform_/normal_/exponential_ in random.py — not duplicated here)
    "add_", "subtract_", "multiply_", "divide_", "ceil_", "clip_",
    "erfinv_", "exp_", "flatten_", "floor_", "index_add_", "lerp_",
    "put_along_axis_", "reciprocal_", "remainder_", "round_", "scale_",
    "sqrt_", "squeeze_", "tanh_", "unsqueeze_", "zero_", "fill_",
    # aliases & stragglers
    "mm", "inverse", "addmm", "frexp", "nanmedian", "nanquantile",
    "take", "vsplit", "hsplit", "dsplit", "reverse", "strided_slice",
    "broadcast_shape", "lu_unpack", "erfinv",
    "is_complex", "is_floating_point", "is_integer", "set_printoptions",
    # TensorArray (static-graph parity)
    "create_array", "array_write", "array_read", "array_length",
    "create_tensor",
]


# ---------------------------------------------------------------------------
# inplace machinery
# ---------------------------------------------------------------------------

def _inplace(fn):
    """Lift a functional op into its `op_` variant."""
    def op_(x, *args, **kwargs):
        out = fn(tape_snapshot(x), *args, **kwargs)
        rebind_inplace(x, out)
        return x
    return op_


add_ = _inplace(_math.add)
subtract_ = _inplace(_math.subtract)
multiply_ = _inplace(_math.multiply)
divide_ = _inplace(_math.divide)
ceil_ = _inplace(_math.ceil)
clip_ = _inplace(_math.clip)
exp_ = _inplace(_math.exp)
floor_ = _inplace(_math.floor)
lerp_ = _inplace(_math.lerp)
reciprocal_ = _inplace(_math.reciprocal)
remainder_ = _inplace(_math.remainder)
round_ = _inplace(_math.round)
scale_ = _inplace(_math.scale)
sqrt_ = _inplace(_math.sqrt)
tanh_ = _inplace(_math.tanh)
flatten_ = _inplace(_manip.flatten)
squeeze_ = _inplace(_manip.squeeze)
unsqueeze_ = _inplace(_manip.unsqueeze)
index_add_ = _inplace(_manip.index_add)
put_along_axis_ = _inplace(_manip.put_along_axis)


def zero_(x):
    x._set_array(torch.zeros_like(x._t.detach()))
    return x


def fill_(x, value):
    x._set_array(torch.full_like(x._t.detach(), value))
    return x


# ---------------------------------------------------------------------------
# math / linalg stragglers
# ---------------------------------------------------------------------------

def erfinv(x, name=None):
    return apply_op(torch.erfinv, x, op_name="erfinv")


erfinv_ = _inplace(erfinv)


def mm(input, mat2, name=None):
    """Alias of matmul."""
    return _linalg.matmul(input, mat2)


def inverse(x, name=None):
    """Alias of linalg.inv."""
    return _linalg.inv(x)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta*input + alpha*(x @ y)."""
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y,
                    op_name="addmm")


def frexp(x, name=None):
    """(mantissa in ±[0.5, 1), exponent); zeros give (0, 0)."""
    def _f(a):
        af = a.float()
        one = torch.ones_like(af)
        exp = torch.where(af == 0, torch.zeros_like(af),
                          torch.floor(torch.log2(torch.abs(
                              torch.where(af == 0, one, af)))) + 1)
        mant = af / torch.exp2(exp)
        return mant.to(a.dtype), exp.to(a.dtype)
    return apply_op(_f, x, op_name="frexp", n_outs=2)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """The median ignoring NaNs, the two middles averaged
    (``jnp.nanmedian``)."""
    return nanquantile(x, 0.5, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    def _f(a):
        flat, keep = _math._to_last(a, axis)
        qt = torch.as_tensor(q, dtype=flat.dtype, device=a.device)
        out = torch.nanquantile(flat, qt, dim=-1)
        if keepdim:
            out = out.reshape(list(qt.shape) + keep)
        return out.to(a.dtype)
    return apply_op(_f, x, op_name="nanquantile")


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """paddle.linalg.lu's results as P, L, U with A = P L U."""
    return apply_op(lambda lu_arr, piv: tuple(torch.lu_unpack(lu_arr, piv)),
                    x, y, op_name="lu_unpack", n_outs=3)


# ---------------------------------------------------------------------------
# manipulation stragglers
# ---------------------------------------------------------------------------

def take(x, index, mode="raise", name=None):
    """Gather from the flattened tensor."""
    assert mode in ("raise", "wrap", "clip")
    n_elems = int(np.prod(x.shape)) if isinstance(x, Tensor) \
        else int(np.asarray(x).size)
    idx_t = index._t if isinstance(index, Tensor) else torch.as_tensor(index)
    if mode == "raise" and idx_t.numel():
        lo, hi = int(idx_t.min()), int(idx_t.max())
        if lo < -n_elems or hi >= n_elems:
            raise ValueError(
                f"take(mode='raise'): index out of range for tensor with "
                f"{n_elems} elements (got min {lo}, max {hi})")

    def _f(a, idx):
        flat = a.reshape(-1)
        i = idx.long()
        if mode == "raise":
            i = torch.where(i < 0, i + n_elems, i)
        if mode == "wrap":
            i = torch.remainder(i, n_elems)
        else:
            i = i.clamp(0, n_elems - 1)
        return flat[i.reshape(-1)].reshape(idx.shape)
    return apply_op(_f, x, index, op_name="take")


def vsplit(x, num_or_sections, name=None):
    assert x.ndim >= 2, "vsplit expects ndim >= 2"
    return _manip.split(x, num_or_sections, axis=0)


def hsplit(x, num_or_sections, name=None):
    axis = 0 if x.ndim == 1 else 1
    return _manip.split(x, num_or_sections, axis=axis)


def dsplit(x, num_or_sections, name=None):
    assert x.ndim >= 3, "dsplit expects ndim >= 3"
    return _manip.split(x, num_or_sections, axis=2)


def reverse(x, axis, name=None):
    """Legacy alias of flip."""
    return _manip.flip(x, axis)


def strided_slice(x, axes, starts, ends, strides, name=None):
    """numpy slicing ``start:end:stride`` along each axis (negative
    strides too)."""
    def _f(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            pos = range(a.shape[ax])[slice(s, e, st)]
            a = torch.index_select(a, ax, torch.tensor(
                list(pos), dtype=torch.long, device=a.device))
        return a
    return apply_op(_f, x, op_name="strided_slice")


def broadcast_shape(x_shape, y_shape):
    """Pure shape math."""
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# ---------------------------------------------------------------------------
# dtype predicates & printing
# ---------------------------------------------------------------------------

def _dtype_of(x):
    return x.dtype if isinstance(x, Tensor) else torch.as_tensor(x).dtype


def is_complex(x):
    return _dtype_of(x).is_complex


def is_floating_point(x):
    return _dtype_of(x).is_floating_point


def is_integer(x):
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor reprs render through numpy, so numpy's printoptions are
    the knob."""
    kwargs = {}
    if precision is not None:
        kwargs["precision"] = precision
    if threshold is not None:
        kwargs["threshold"] = threshold
    if edgeitems is not None:
        kwargs["edgeitems"] = edgeitems
    if linewidth is not None:
        kwargs["linewidth"] = linewidth
    if sci_mode is not None:
        kwargs["suppress"] = not sci_mode
    np.set_printoptions(**kwargs)


# ---------------------------------------------------------------------------
# TensorArray: in eager mode a Python list of Tensors.
# ---------------------------------------------------------------------------

def create_array(dtype="float32", initialized_list=None):
    arr = list(initialized_list) if initialized_list else []
    for v in arr:
        assert isinstance(v, Tensor), \
            "create_array initialized_list must hold Tensors"
    return arr


def array_write(x, i, array=None):
    i = int(i.numpy()) if isinstance(i, Tensor) else int(i)
    if array is None:
        array = []
    if i < len(array):
        array[i] = x
    else:
        assert i == len(array), \
            f"array_write index {i} out of range {len(array)}"
        array.append(x)
    return array


def array_read(array, i):
    i = int(i.numpy()) if isinstance(i, Tensor) else int(i)
    return array[i]


def array_length(array):
    return len(array)


def create_tensor(dtype, name=None, persistable=False):
    from ..core.dtype import convert_dtype
    from ..core.place import current_device
    return Tensor._wrap(torch.zeros([], dtype=convert_dtype(dtype),
                                    device=current_device()))
