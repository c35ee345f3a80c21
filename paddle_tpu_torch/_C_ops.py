"""paddle._C_ops: the eager fast path (the port of
``paddle_tpu/_C_ops.py``; reference analog python/paddle/_C_ops.py:19,
symbols bound from core.eager.ops -- CPython wrappers generated by
python_c_gen.py:87 that call the PHI API directly).

``_C_ops.<op>`` resolves the op's torch-level function from
``ops.registry`` (``ops.codegen.fast_op``) and returns it on raw torch
tensors: callers that want to skip the ``Tensor`` facade get the torch
computation directly.  Resolution is lazy per attribute.
"""
from __future__ import annotations

from .ops.codegen import fast_op


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    fn = fast_op(name)
    globals()[name] = fn  # cache for subsequent lookups
    return fn


def __dir__():
    from .ops.registry import OP_LIBRARY
    return sorted(OP_LIBRARY)
