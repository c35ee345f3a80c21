"""Tensor creation ops (the port of ``paddle_tpu/tensor/creation.py``).

Every tensor is created on the current place
(``core.place.current_device``); ``*_like`` ops on their input's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor
from ..core.place import current_device
from ..core import dtype as dtype_mod
from ..ops.registry import register, _ensure_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "tril", "triu", "meshgrid", "diag", "diagflat", "diag_embed",
    "assign", "clone", "tril_indices", "triu_indices", "complex",
    "create_parameter",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = default or dtype_mod.get_default_dtype()
    return d


def _new(t):
    return Tensor._wrap(t)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape_list(shape), dtype=_dt(dtype),
                            device=current_device()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape_list(shape), dtype=_dt(dtype),
                           device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, int):
            dtype = torch.int64
        else:
            dtype = dtype_mod.get_default_dtype()
    return _new(torch.full(_shape_list(shape), fill_value, dtype=_dt(dtype),
                           device=current_device()))


def zeros_like(x, dtype=None, name=None):
    x = _ensure_tensor(x)
    return _new(torch.zeros_like(x._t, dtype=dtype_mod.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    x = _ensure_tensor(x)
    return _new(torch.ones_like(x._t, dtype=dtype_mod.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    x = _ensure_tensor(x)
    return _new(torch.full_like(x._t, fill_value,
                                dtype=dtype_mod.convert_dtype(dtype)))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _v(x):
    return x.item() if isinstance(x, Tensor) else x


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
            dtype = torch.int64
        else:
            dtype = dtype_mod.get_default_dtype()
    return _new(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_v(start), _v(stop), int(_v(num)),
                               dtype=_dt(dtype, torch.float32),
                               device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_v(start), _v(stop), int(_v(num)),
                               base=_v(base), dtype=_dt(dtype, torch.float32),
                               device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye(num_rows, num_columns if num_columns is not None
                          else num_rows, dtype=_dt(dtype),
                          device=current_device()))


def tril(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.tril(a, diagonal), _ensure_tensor(x),
                    op_name="tril")


def triu(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.triu(a, diagonal), _ensure_tensor(x),
                    op_name="triu")


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    tensors = [_ensure_tensor(a) for a in args]
    outs = apply_op(lambda *arrs: tuple(torch.meshgrid(*arrs, indexing="ij")),
                    *tensors, op_name="meshgrid")
    return list(outs)


def diag(x, offset=0, padding_value=0, name=None):
    x = _ensure_tensor(x)

    def _diag(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(mask, out, torch.as_tensor(
                    padding_value, dtype=a.dtype, device=a.device))
            return out
        return torch.diagonal(a, offset)
    return apply_op(_diag, x, op_name="diag")


def diagflat(x, offset=0, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.diagflat(a, offset), x,
                    op_name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    # the reference places the diagonals in the last two axes whatever
    # dim1 / dim2 say
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.diag_embed(a, offset, -2, -1), x,
                    op_name="diag_embed")


def assign(x, output=None):
    x = to_tensor(x) if isinstance(x, (list, tuple, np.ndarray, int, float,
                                       bool)) else _ensure_tensor(x)
    out = apply_op(torch.clone, x, op_name="assign")
    if output is not None:
        output._set_array(out._t)
        return output
    return out


def clone(x, name=None):
    return _ensure_tensor(x).clone()


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return _new(torch.tril_indices(row, col, offset, dtype=_dt(dtype),
                                   device=current_device()))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return _new(torch.triu_indices(row, col, offset, dtype=_dt(dtype),
                                   device=current_device()))


def complex(real, imag, name=None):  # noqa: A001
    return apply_op(torch.complex, _ensure_tensor(real),
                    _ensure_tensor(imag), op_name="complex")


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a trainable leaf Tensor."""
    from ..nn.initializer import _resolve_initializer
    init = _resolve_initializer(attr, default_initializer, is_bias)
    t = Tensor(init(_shape_list(shape), _dt(dtype)), stop_gradient=False)
    t.is_leaf_param = True
    t.persistable = True
    if name:
        t.name = name
    return t


for _n in __all__:
    if _n not in ("to_tensor",):
        register(_n, globals()[_n])
