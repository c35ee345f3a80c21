"""Host-to-card staging ahead of the step (the port of
``paddle_tpu/io/device_loader.py``).

The reference hands each batch to ``jax.device_put``, whose transfer runs
off the Python thread.  Here every tensor of a batch is copied into
pinned host memory and onto the card with a ``non_blocking`` copy on a
CUDA stream of the loader's own, ``buffer_size`` batches ahead of the
consumer, so the copy of batch N + 1 overlaps the step on batch N.
Before a batch is handed over, the consumer's stream waits on the event
recorded after its copies (a step that read it earlier could see a
half-copied batch), and each of its tensors is marked as used on the
consumer's stream, so the caching allocator does not hand its memory to
another tensor while the step still reads it.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DeviceDataLoader", "stage_to_device"]


def _map(batch, fn):
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map(b, fn) for b in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch):
    out = []
    _map(batch, lambda x: out.append(x) if torch.is_tensor(x) else None)
    return out


def stage_to_device(batch, device=None):
    """Every tensor (or numpy array) leaf of ``batch`` on ``device`` (the
    card unless the caller names another), the structure kept.  To a
    card the copies come from pinned host memory and do not block the
    host: they are ordered on the current stream."""
    dev = resolve_device(device)

    def stage(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not torch.is_tensor(leaf):
            return leaf
        if dev.type == "cuda" and leaf.device.type == "cpu":
            if not leaf.is_pinned():
                leaf = leaf.pin_memory()
            return leaf.to(dev, non_blocking=True)
        return leaf.to(dev)
    return _map(batch, stage)


class DeviceDataLoader:
    """Wraps any batch iterable and yields its batches on ``place`` (the
    card unless the caller names another), ``buffer_size`` batches
    staged ahead of the consumer."""

    def __init__(self, loader: Iterable, place=None, buffer_size: int = 2):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self._loader = loader
        self._device = resolve_device(place)
        self._buffer_size = buffer_size

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        dev = self._device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        buf: deque = deque()
        for batch in self._loader:
            buf.append(self._stage(batch, side))
            if len(buf) > self._buffer_size:
                yield self._hand_over(buf.popleft())
        while buf:
            yield self._hand_over(buf.popleft())

    def _stage(self, batch, side):
        if side is None:
            return stage_to_device(batch, self._device), None
        # the side stream must not copy into memory the consumer's stream
        # last freed before that stream's work reached this point
        side.wait_stream(torch.cuda.current_stream(self._device))
        with torch.cuda.stream(side):
            staged = stage_to_device(batch, self._device)
            done = torch.cuda.Event()
            done.record(side)
        return staged, done

    def _hand_over(self, item):
        staged, done = item
        if done is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(done)
            for t in _leaves(staged):
                if t.device.type == "cuda":
                    t.record_stream(cur)
        return staged
