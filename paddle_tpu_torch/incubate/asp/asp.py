"""ASP workflow: prune, train with the masks kept, check (the port of
``paddle_tpu/incubate/asp/asp.py``; reference:
python/paddle/incubate/asp/asp.py prune_model:302, decorate:216,
set_excluded_layers:40, ASPHelper:515,
OptimizerWithSparsityGuarantee:918).

The masks are computed on the parameters' device (``utils.create_mask``:
the 1-D mask by a stable sort, bit-equal to the reference's numpy mask)
and live on the pruned parameters themselves (``param._asp_mask``), so
their lifetime is the parameter's.  After every optimizer step the
masks are applied again, an in-place multiply, so pruned weights stay
exactly zero through training.
"""
from __future__ import annotations

import torch

from . import utils

__all__ = ["prune_model", "decorate", "set_excluded_layers",
           "reset_excluded_layers", "ASPHelper"]


class ASPHelper:
    """reference: asp.py:515 -- tracks exclusions; masks live on the
    pruned parameters (``param._asp_mask``)."""

    MASK_APPENDDED_NAME = "_asp_mask"
    _excluded_layers: list = []

    @classmethod
    def is_supported_layer(cls, param_name: str, param) -> bool:
        if param.ndim < 2:
            return False  # biases / norms
        for ex in cls._excluded_layers:
            if ex and ex in param_name:
                return False
        return True

    @classmethod
    def prune_model(cls, model, n=2, m=4, mask_algo=utils.MaskAlgo.MASK_1D,
                    with_mask=True):
        masks = {}
        for name, param in model.named_parameters():
            if not cls.is_supported_layer(name, param):
                continue
            mask = utils.create_mask(param._t, func_name=mask_algo, n=n, m=m)
            with torch.no_grad():
                param._t.mul_(mask)
            if with_mask:
                setattr(param, cls.MASK_APPENDDED_NAME, mask)
            masks[name] = mask
        return masks

    @classmethod
    def reapply_masks(cls, parameters):
        with torch.no_grad():
            for p in parameters:
                mask = getattr(p, cls.MASK_APPENDDED_NAME, None)
                if mask is not None:
                    p._t.mul_(mask)


def set_excluded_layers(param_names, main_program=None):
    """reference: asp.py:40 -- names (substrings) to skip when pruning."""
    ASPHelper._excluded_layers = list(param_names)


def reset_excluded_layers(main_program=None):
    """reference: asp.py:127."""
    ASPHelper._excluded_layers = []


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """reference: asp.py:302 -- compute and apply n:m masks over every
    supported parameter; returns {param_name: mask}."""
    return ASPHelper.prune_model(model, n=n, m=m, mask_algo=mask_algo,
                                 with_mask=with_mask)


class OptimizerWithSparsityGuarantee:
    """reference: asp.py:918 -- applies the masks again after every step
    so pruned weights stay exactly zero through training."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def _params(self):
        return getattr(self._optimizer, "_parameter_list", None) or []

    def step(self):
        self._optimizer.step()
        ASPHelper.reapply_masks(self._params())

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        out = self._optimizer.minimize(loss, startup_program, parameters,
                                       no_grad_set)
        ASPHelper.reapply_masks(self._params())
        return out

    def clear_grad(self, *a, **k):
        return self._optimizer.clear_grad(*a, **k)


def decorate(optimizer):
    """reference: asp.py:216."""
    return OptimizerWithSparsityGuarantee(optimizer)
