"""Activation recompute (the port of
``paddle_tpu/distributed/recompute.py``; Paddle's
``fleet/recompute/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
activations and runs it again inside the backward to get them, as one
``torch.autograd.Function`` whose inputs are the ``Tensor`` arguments
(however deeply they sit in lists, tuples and dicts) and the trainable
parameters the function reaches: a ``Layer``, a bound method of one, or
a plain function or lambda whose closure cells or defaults hold Layers
or tensors (Paddle's ``recompute(create_custom_forward(block), x)``).
Those parameters are inputs of the recomputed region, so their
gradients arrive through autograd like any other (a ``DataParallel``
hook fires on them as usual).

The replay must draw the same random numbers as the forward did, or a
dropout inside the region draws another mask and the gradients are
silently wrong.  ``torch.utils.checkpoint``'s ``preserve_rng_state``
stashes torch's default generators only, and the eager core draws from
its own (``framework.random``: a ``torch.Generator`` per device, or a
tracker's while ``RNGStatesTracker.rng_state`` is entered).  So with
``preserve_rng_state`` (the default) the forward stashes the state of
the generator that was the global one, of every tracked generator and of
torch's own; the replay runs from that stash, and every one of them is
put back as it was before the replay.  ``use_reentrant`` is accepted and
changes nothing (one implementation, as in the reference).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..core.tensor import Tensor
from ..framework import random as global_rng
from .random import get_rng_state_tracker

__all__ = ["recompute", "recompute_sequential"]


def _closure_params(function: Callable):
    """The trainable parameters reachable from the callable (the
    reference's walk: a Layer, a bound method's Layer, closure cells and
    defaults, lists and tuples, three levels deep)."""
    from ..nn.layer.layers import Layer

    seen_params = {}
    seen_objs = set()

    def visit(obj, depth=0):
        if obj is None or id(obj) in seen_objs or depth > 3:
            return
        seen_objs.add(id(obj))
        if isinstance(obj, Layer):
            for p in obj.parameters():
                if not p.stop_gradient:
                    seen_params.setdefault(id(p), p)
        elif isinstance(obj, Tensor):
            if not obj.stop_gradient:
                seen_params.setdefault(id(obj), obj)
        elif callable(obj):
            visit(getattr(obj, "__self__", None), depth + 1)
            for cell in (getattr(obj, "__closure__", None) or ()):
                try:
                    visit(cell.cell_contents, depth + 1)
                except ValueError:  # empty cell
                    pass
            for d in (getattr(obj, "__defaults__", None) or ()):
                visit(d, depth + 1)
        elif isinstance(obj, (list, tuple)):
            for item in obj:
                visit(item, depth + 1)

    visit(function)
    return list(seen_params.values())


def _flatten(tree, out):
    """The Tensors of a nest of lists, tuples and dicts, in order, and a
    rebuild function over replacements for them."""
    if isinstance(tree, Tensor):
        out.append(tree)
        return lambda it: next(it)
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(x, out) for x in tree]
        kind = type(tree)
        return lambda it: kind(s(it) for s in subs)
    if isinstance(tree, dict):
        subs = {k: _flatten(v, out) for k, v in tree.items()}
        return lambda it: {k: s(it) for k, s in subs.items()}
    return lambda it: tree


class _RNG:
    """The states of the generators a region may draw from: the global
    one (whichever object that is), the tracker's, and torch's own."""

    def __init__(self, extra=()):
        self.default = global_rng.default_generator
        gens = {id(g): g for g in (self.default, *extra,
                                   *get_rng_state_tracker().states_.values())}
        self.states = [(g, g.get_state()) for g in gens.values()]
        self.cpu = torch.get_rng_state()
        self.cuda = (torch.cuda.get_rng_state_all()
                     if torch.cuda.is_initialized() else None)

    def restore(self):
        global_rng.default_generator = self.default
        for g, st in self.states:
            g.set_state(st)
        torch.set_rng_state(self.cpu)
        if self.cuda is not None:
            torch.cuda.set_rng_state_all(self.cuda)


class _Recompute(torch.autograd.Function):
    """Inputs: the arguments' tensors, then the parameters' (whose
    gradients the replay computes and autograd accumulates)."""

    @staticmethod
    def forward(ctx, run, preserve, n_args, *tensors):
        ctx.run, ctx.n_args = run, n_args
        ctx.rng = _RNG() if preserve else None
        ctx.params = tensors[n_args:]
        ctx.save_for_backward(*tensors[:n_args])
        return tuple(run(tensors[:n_args]))

    @staticmethod
    def backward(ctx, *grads):
        args = [t.detach().requires_grad_(t.requires_grad)
                for t in ctx.saved_tensors]
        now = None
        if ctx.rng is not None:
            now = _RNG((ctx.rng.default,))
            ctx.rng.restore()
        try:
            with torch.enable_grad():
                outs = ctx.run(args)
        finally:
            if now is not None:
                now.restore()
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in (*args, *ctx.params) if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, None, None, *[next(got) if t.requires_grad else None
                                    for t in (*args, *ctx.params)])


def _recompute(function: Callable, params, args, kwargs, preserve: bool):
    """``function(*args, **kwargs)`` as one recomputed region over the
    tensors in ``args`` / ``kwargs`` and ``params``."""
    leaves: list = []
    rebuild = _flatten((args, kwargs), leaves)
    out_shape: list = []

    def run(tensors):
        a, k = rebuild(iter(Tensor._wrap(t) for t in tensors))
        out = function(*a, **k)
        found: list = []
        out_shape[:] = [_flatten(out, found)]
        return [t._t for t in found]

    flat = _Recompute.apply(run, preserve, len(leaves),
                            *[t._t for t in leaves],
                            *[p._t for p in params])
    return out_shape[0](iter(Tensor._wrap(t) for t in flat))


def recompute(function: Callable, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its
    activations; the backward recomputes them.  ``preserve_rng_state``
    (default True): the replay draws what the forward drew.
    ``use_reentrant`` is accepted and ignored."""
    preserve = bool(kwargs.pop("preserve_rng_state", True))
    kwargs.pop("use_reentrant", None)
    return _recompute(function, _closure_params(function), args, kwargs,
                      preserve)


def recompute_sequential(ctx: dict, functions: Sequence[Callable], *args):
    """``functions`` applied in turn (each to the previous output; a
    tuple is spread), recomputed in ``ctx["segments"]`` chunks (default
    1), each a region of its own."""
    ctx = ctx or {}
    segments = int(ctx.get("segments", 1))
    preserve = bool(ctx.get("preserve_rng_state", True))
    functions = list(functions)
    seg = max(1, -(-len(functions) // max(1, segments)))

    def make_chunk(fns):
        def chunk(*xs):
            out = xs
            for f in fns:
                out = f(*out) if isinstance(out, tuple) else f(out)
            return out
        return chunk

    out: Any = args
    for start in range(0, len(functions), seg):
        fns = functions[start:start + seg]
        params = {}
        for f in fns:
            for p in _closure_params(f):
                params.setdefault(id(p), p)
        out_t = out if isinstance(out, tuple) else (out,)
        out = _recompute(make_chunk(fns), list(params.values()), out_t, {},
                         preserve)
    return out
