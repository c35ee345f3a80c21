"""Dtypes of the eager core: Paddle's names over ``torch.dtype``.

The port of ``paddle_tpu/core/dtype.py``.  A dtype here IS a
``torch.dtype`` (``paddle.float32 is torch.float32``); this module adds
the Paddle spellings, the default float dtype and ``finfo`` / ``iinfo``.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "float64": float64, "fp64": float64,
    "complex64": complex64, "complex128": complex128,
}

_NUMPY_TO_DTYPE = {
    np.dtype(np.bool_): bool_, np.dtype(np.uint8): uint8,
    np.dtype(np.int8): int8, np.dtype(np.int16): int16,
    np.dtype(np.int32): int32, np.dtype(np.int64): int64,
    np.dtype(np.float16): float16, np.dtype(np.float32): float32,
    np.dtype(np.float64): float64, np.dtype(np.complex64): complex64,
    np.dtype(np.complex128): complex128,
}

_DEFAULT_DTYPE = [torch.float32]


def convert_dtype(dtype):
    """A string, numpy dtype, Python type or ``torch.dtype`` as a
    ``torch.dtype`` (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return get_default_dtype()
    try:
        nd = np.dtype(dtype)
    except TypeError:
        raise TypeError(f"Unsupported dtype: {dtype!r}") from None
    if nd.name == "bfloat16":
        return bfloat16
    if nd not in _NUMPY_TO_DTYPE:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _NUMPY_TO_DTYPE[nd]


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).replace("torch.", "")


def set_default_dtype(d):
    """paddle.set_default_dtype: a floating dtype only."""
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d == bool_ or not (d.is_floating_point or d.is_complex)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
