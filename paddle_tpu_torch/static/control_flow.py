"""Control-flow ops: cond / while_loop / switch_case / case (the port of
``paddle_tpu/static/control_flow.py``; reference analog
python/paddle/static/nn/control_flow.py cond:392, while_loop:1049,
switch_case:1211).

- Concrete predicate: plain Python dispatch; only the taken branch
  runs, and autograd flows through it like any op.
- Traced predicate (a fake tensor of ``torch.export``, i.e. inside
  ``jit.to_static`` / ``jit.save``): ``torch.cond`` /
  ``torch._higher_order_ops.while_loop``, the reference's ``lax.cond`` /
  ``lax.while_loop``.  Both branches are captured, so their outputs
  must match in structure, shape and dtype (``torch.cond`` refuses what
  ``lax.cond`` refuses); a Python number a branch or a loop body returns
  becomes a tensor (the reference's weak-typed scalars), a loop body's
  outputs take their carry's dtype, and an output that is its own input
  is copied (the higher-order ops refuse aliasing).  ``switch_case``
  lowers to nested ``torch.cond`` over the keys.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor

__all__ = ["cond", "while_loop", "switch_case", "case", "is_traced"]


def _raw(x):
    return x._t if isinstance(x, Tensor) else x


def is_traced(t) -> bool:
    """True for a tensor of a capture (a fake or functional tensor, as
    ``torch.export`` traces with, or any tensor inside a higher-order
    op's body), False for a real tensor or anything else."""
    t = _raw(t)
    if not torch.is_tensor(t):
        return False
    if torch.compiler.is_compiling():
        # inside a branch or loop body the higher-order op traces with
        # dynamo: every tensor there is traced
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    from torch._subclasses.functional_tensor import FunctionalTensor
    return isinstance(t, (FakeTensor, FunctionalTensor))


def _as_tensor(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A branch or body output as a torch tensor on ``like``'s device."""
    t = _raw(v)
    if not torch.is_tensor(t):
        if dtype is None:
            dtype = (torch.bool if isinstance(t, bool) else torch.int64
                     if isinstance(t, int) else torch.float32)
        t = torch.tensor(t, dtype=dtype, device=like.device)
    elif dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


def _pred(p) -> torch.Tensor:
    p = _raw(p)
    if p.numel() != 1:
        raise ValueError(f"cond: the predicate must hold one element, got "
                         f"shape {tuple(p.shape)}")
    p = p.reshape(())
    return p if p.dtype == torch.bool else p != 0


def cond(pred, true_fn: Callable, false_fn: Callable, name=None,
         return_names=None):
    """Run ``true_fn()`` if pred else ``false_fn()``
    (reference static/nn/control_flow.py:392)."""
    p = _raw(pred)
    if not is_traced(p):
        return true_fn() if bool(p) else false_fn()
    p = _pred(p)

    def wrap(fn):
        # the branches' outputs as torch pytrees (torch.cond flattens and
        # checks them); no side effect, since the branches are traced
        return lambda: pytree.tree_map(lambda v: _as_tensor(v, p), fn())

    return pytree.tree_map(Tensor._wrap,
                           torch.cond(p, wrap(true_fn), wrap(false_fn), ()))


def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence, is_test=False, name=None):
    """Iterate ``body_fn(*vars)`` while ``cond_fn(*vars)``
    (reference static/nn/control_flow.py:1049)."""
    traced = any(is_traced(v) for v in loop_vars) or is_traced(
        cond_fn(*loop_vars))
    if not traced:
        vals = list(loop_vars)
        while bool(_raw(cond_fn(*vals))):
            out = body_fn(*vals)
            vals = list(out) if isinstance(out, (tuple, list)) else [out]
        return vals
    like = next(_raw(v) for v in loop_vars if torch.is_tensor(_raw(v))) \
        if any(torch.is_tensor(_raw(v)) for v in loop_vars) \
        else _raw(cond_fn(*loop_vars))
    carries = tuple(_as_tensor(v, like) for v in loop_vars)
    dtypes = [c.dtype for c in carries]

    def acond(*ts):
        return _pred(_as_tensor(cond_fn(*[Tensor._wrap(t) for t in ts]),
                                like))

    def abody(*ts):
        out = body_fn(*[Tensor._wrap(t) for t in ts])
        if not isinstance(out, (tuple, list)):
            out = (out,)
        if len(out) != len(ts):
            raise ValueError(f"while_loop: the body returns {len(out)} "
                             f"values for {len(ts)} loop variables")
        res = []
        for o, t, dt in zip(out, ts, dtypes):
            o = _as_tensor(o, like, dt)
            res.append(o.clone() if o is t else o)
        return tuple(res)

    from torch._higher_order_ops.while_loop import while_loop as _while
    out = _while(acond, abody, carries)
    return [Tensor._wrap(o) for o in out]


def switch_case(branch_index, branch_fns: Union[Dict, List, tuple],
                default: Callable = None, name=None):
    """Dispatch on an integer index with an optional default
    (reference static/nn/control_flow.py:1211)."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((int(k), f) for k, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    keys = [int(k) for k, _ in items]
    fns = [f for _, f in items]
    if default is None:
        default = fns[-1]  # reference: the last branch doubles as default

    idx = _raw(branch_index)
    if not is_traced(idx):
        i = int(idx)
        return dict(zip(keys, fns)).get(i, default)()

    def build(pairs):
        if not pairs:
            return default
        (k, f), rest = pairs[0], pairs[1:]
        return lambda: cond(idx.reshape(()) == k, f, build(rest))

    return build(list(zip(keys, fns)))()


def case(pred_fn_pairs: Sequence, default: Callable = None, name=None):
    """The first pair whose predicate holds wins (reference
    static/nn/control_flow.py case): nested ``cond``, so it works traced
    as well as eagerly."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    if default is None:
        default = pred_fn_pairs[-1][1]

    def build(pairs):
        if not pairs:
            return default
        (p, f), rest = pairs[0], pairs[1:]
        return lambda: cond(p, f, build(rest))

    return build(list(pred_fn_pairs))()
