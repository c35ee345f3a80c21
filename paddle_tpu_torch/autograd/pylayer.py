"""PyLayer: user-defined forward and backward (the port of
``paddle_tpu/autograd/pylayer.py``) as a ``torch.autograd.Function``:
``forward`` and ``backward`` take and return ``Tensor``s."""
from __future__ import annotations

from typing import List

import torch

from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "saved_tensors_hooks"]


class PyLayerContext:
    def __init__(self):
        self._saved: List[tuple] = []
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        # the active (pack, unpack) pair travels with the saved value:
        # backward may run after the hooks' context has exited
        if _SAVED_HOOKS:
            pack, unpack = _SAVED_HOOKS[-1]
            self._saved = [(pack(t), unpack) for t in tensors]
        else:
            self._saved = [(t, None) for t in tensors]

    def saved_tensor(self):
        return [unpack(v) if unpack is not None else v
                for v, unpack in self._saved]


# active (pack, unpack) hook pairs, innermost last
_SAVED_HOOKS: List[tuple] = []


class saved_tensors_hooks:  # noqa: N801 — reference spelling
    """``pack`` runs when a PyLayer saves a tensor for backward and
    ``unpack`` when backward takes it back (the explicit
    ``save_for_backward`` channel, as in the reference)."""

    def __init__(self, pack_hook, unpack_hook):
        self._pair = (pack_hook, unpack_hook)

    def __enter__(self):
        _SAVED_HOOKS.append(self._pair)
        return self

    def __exit__(self, *exc):
        _SAVED_HOOKS.remove(self._pair)
        return False


class PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError(
            f"{cls.__name__} should not be instantiated; call "
            f"{cls.__name__}.apply(...) instead.")


class _Function(torch.autograd.Function):
    """Runs a PyLayer's static forward / backward over the facade."""

    @staticmethod
    def forward(ctx, layer, kwargs, spec, box, *raw):
        pctx = PyLayerContext()
        args = [Tensor._wrap(r) if is_t else r for r, is_t in zip(raw, spec)]
        outputs = layer.forward(pctx, *args, **kwargs)
        multi = isinstance(outputs, (tuple, list))
        outs = list(outputs) if multi else [outputs]
        ctx.pylayer = (layer, pctx, spec)
        res = tuple(o._t if isinstance(o, Tensor)
                    else torch.as_tensor(o) for o in outs)
        box.append(multi)
        return res

    @staticmethod
    def backward(ctx, *grads):
        layer, pctx, spec = ctx.pylayer
        res = layer.backward(pctx, *[Tensor._wrap(g) for g in grads])
        if not isinstance(res, (tuple, list)):
            res = (res,)
        it = iter(res)
        out = []
        for is_t in spec:
            g = next(it, None) if is_t else None
            out.append(g._t if isinstance(g, Tensor) else g)
        return (None, None, None, None, *out)


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        spec = tuple(isinstance(a, Tensor) for a in args)
        raw = [a._t if isinstance(a, Tensor) else a for a in args]
        box = []
        outs = _Function.apply(cls, kwargs, spec, box, *raw)
        wrapped = tuple(Tensor._wrap(o) for o in outs)
        return wrapped if box[0] else wrapped[0]
