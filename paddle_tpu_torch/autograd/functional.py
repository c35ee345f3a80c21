"""The functional autograd API (the port of
``paddle_tpu/autograd/functional.py``).

``paddle.grad`` is ``torch.autograd.grad`` (``create_graph`` gives
higher orders); ``vjp`` / ``jvp`` / ``jacobian`` / ``hessian`` are
``torch.autograd``'s over a function of ``Tensor``s.
"""
from __future__ import annotations

import torch

from ..core import tensor as _core
from ..core.tensor import Tensor, _as_torch

__all__ = ["grad", "vjp", "jvp", "jacobian", "hessian"]


def _listify(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """The gradients of ``outputs`` w.r.t. ``inputs``, leaving every
    ``.grad`` as it was.  The paths through ``no_grad_vars`` are cut
    for the call, as the reference cuts them (it sets their
    ``stop_gradient``): an input reached only through them, or through a
    tensor marked ``stop_gradient`` after the fact, has no gradient."""
    outputs = _listify(outputs)
    inputs = _listify(inputs)
    grad_outputs = _listify(grad_outputs) or [None] * len(outputs)
    seeds = [torch.ones_like(o._t) if g is None
             else _as_torch(g._t if isinstance(g, Tensor) else g,
                            o._t.dtype, o._t.device)
             for o, g in zip(outputs, grad_outputs)]
    removers, cut_ids = [], set()
    for v in _listify(no_grad_vars):
        t = v._t
        cut_ids.add(id(t))
        if t.requires_grad and t.grad_fn is not None:
            removers.append(_core._cut(t))
    try:
        res = torch.autograd.grad(
            [o._t for o in outputs], [i._t for i in inputs], seeds,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        if _core._LIVE_CUTS[0] or cut_ids:
            reached = _core._reached([o._t for o in outputs], cut_ids)
            res = [None if g is None or id(i._t) in cut_ids
                   or not _core._is_reached(i._t, reached) else g
                   for g, i in zip(res, inputs)]
    finally:
        for r in removers:
            if r is not None:
                r()
    out = []
    for g in res:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "One of the differentiated tensors appears unused; "
                    "pass allow_unused=True to get None for it.")
            out.append(None)
        else:
            out.append(Tensor._wrap(g if create_graph else g.detach()))
    return out


def _wrap_fn(func):
    """``func`` of Tensors as a function of torch tensors."""
    def raw(*arrays):
        out = func(*[Tensor._wrap(a) for a in arrays])
        if isinstance(out, (list, tuple)):
            return tuple(o._t if isinstance(o, Tensor) else o for o in out)
        return out._t if isinstance(out, Tensor) else out
    return raw


def _wrap_out(o):
    if isinstance(o, tuple):
        return tuple(_wrap_out(x) for x in o)
    return Tensor._wrap(o.detach())


def _prims(xs):
    return [x._t.detach() for x in _listify(xs)]


def _vs(v, prims):
    if v is None:
        return None
    vs = [t._t if isinstance(t, Tensor) else torch.as_tensor(t)
          for t in _listify(v)]
    return tuple(x.to(p.device, p.dtype) for x, p in zip(vs, prims)) \
        if len(vs) == len(prims) else tuple(vs)


def vjp(func, xs, v=None):
    prims = _prims(xs)
    with torch.enable_grad():
        ins = [p.requires_grad_(True) for p in prims]
        out = _wrap_fn(func)(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        if v is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            cots = [t._t if isinstance(t, Tensor) else torch.as_tensor(t)
                    for t in _listify(v)]
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads_t = [Tensor._wrap(torch.zeros_like(p) if g is None else g)
               for g, p in zip(grads, prims)]
    return _wrap_out(out), grads_t if len(grads_t) > 1 else grads_t[0]


def jvp(func, xs, v=None):
    prims = _prims(xs)
    tangents = _vs(v, prims) if v is not None \
        else tuple(torch.ones_like(p) for p in prims)
    out, jv = torch.autograd.functional.jvp(
        _wrap_fn(func), tuple(prims), tangents)
    return _wrap_out(out), _wrap_out(jv)


def jacobian(func, xs, is_batched=False):
    prims = _prims(xs)
    jac = torch.autograd.functional.jacobian(_wrap_fn(func), tuple(prims))
    out = _wrap_out(jac)
    if len(prims) == 1 and isinstance(out, tuple) and len(out) == 1:
        return out[0]
    return out


def hessian(func, xs, is_batched=False):
    prims = _prims(xs)
    hes = torch.autograd.functional.hessian(_wrap_fn(func), tuple(prims))
    out = _wrap_out(hes)
    if len(prims) == 1 and isinstance(out, tuple) and len(out) == 1:
        o = out[0]
        return o[0] if isinstance(o, tuple) and len(o) == 1 else o
    return out
