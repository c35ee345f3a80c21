"""Crash-consistent ``save`` / ``load`` of a state tree (the port of
``paddle_tpu/framework/io.py``).

A state tree is nested dicts, lists and tuples of torch tensors and
plain Python values.  The file holds the tensors themselves (bf16 as
bf16: numpy has no bfloat16, so the reference's bit-packing tag is not
needed) in ``torch.save``'s format; ``load`` reads it back with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers and never code.  Tensors are saved from the host: a device
tensor is copied to the CPU first, and ``load`` returns CPU tensors
(``map_location=`` places them elsewhere).

``save`` writes a tmp sibling, flushes and fsyncs it, passes the
``io.save.pre_commit`` chaos point and publishes with ``os.replace``: a
kill at any instant leaves the previous complete file or the new one,
never a truncated hybrid.  A truncated or corrupt file makes ``load``
raise ``RuntimeError`` naming it.
"""
from __future__ import annotations

import os
import pickle
import zipfile

import torch

from ..testing.chaos import chaos_point

__all__ = ["save", "load"]


def _host(obj):
    """The tree with every tensor on the CPU (tuples and lists kept)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu() if obj.device.type != "cpu" \
            else obj.detach()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def save(obj, path, **configs):
    """Crash-consistent: serialize into a tmp sibling, fsync it, then
    atomically ``os.replace`` over ``path``.  ``path`` may also be a
    writable binary stream."""
    obj = _host(obj)
    if hasattr(path, "write"):
        torch.save(obj, path)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.ptq-tmp.{os.getpid()}"
    try:
        torch.save(obj, tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        chaos_point("io.save.pre_commit", path=path)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # interrupted before the commit rename
            os.remove(tmp)


_CORRUPT = (pickle.UnpicklingError, EOFError, zipfile.BadZipFile,
            RuntimeError, ValueError)


def load(path, map_location="cpu", **configs):
    """The tree ``save`` wrote, its tensors on ``map_location``.  A
    truncated or corrupt file raises ``RuntimeError`` naming it."""
    name = getattr(path, "name", None) or repr(path)
    try:
        if hasattr(path, "read"):
            return torch.load(path, map_location=map_location,
                              weights_only=True)
        with open(path, "rb") as f:
            return torch.load(f, map_location=map_location,
                              weights_only=True)
    except _CORRUPT as e:
        raise RuntimeError(
            f"checkpoint file {name} is truncated or corrupt "
            f"({type(e).__name__}: {e}); the writing process was likely "
            f"killed mid-save — restore an earlier checkpoint") from e
