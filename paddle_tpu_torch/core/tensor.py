"""The ``Tensor`` facade over a torch tensor, and its autograd.

The port of ``paddle_tpu/core/tensor.py``.  The reference records its
own tape (``apply_op`` runs ``jax.vjp`` and makes a ``TapeNode``;
``run_backward`` replays it).  Here a ``Tensor`` holds one
``torch.Tensor`` (``_t``) and autograd is torch's:

  reference                     port
  stop_gradient                 not requires_grad
  backward                      torch.autograd.backward
  register_hook                 the torch tensor's hook
  no_grad / enable_grad / ...   torch's grad-mode contexts

``Tensor`` is not a subclass of ``torch.Tensor``: Paddle's ``.shape``
is a list, ``.grad`` is a ``Tensor`` and ``reshape`` / ``sum(axis=)``
take Paddle's arguments, all of which would collide with torch's.

Every op goes through ``apply_op``: it unwraps the inputs, runs a
function of torch tensors (torch records the graph), wraps the outputs
and runs the ``FLAGS_check_nan_inf`` check.  An in-place op
(``add_``, ``scale_``, ...) runs its functional op and rebinds the
facade to the result (``tape_snapshot`` + ``rebind_inplace``), so the
old value stays in the graph as it does in JAX.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import dtype as dtype_mod
from .place import _parse_device, current_device, place_of
from ..flags import _REGISTRY as _FLAGS

__all__ = [
    "Tensor", "to_tensor", "apply_op", "no_grad", "enable_grad",
    "is_grad_enabled", "set_grad_enabled",
]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _unwrap(x):
    return x._t if isinstance(x, Tensor) else x


class Tensor:
    """Eager tensor over a ``torch.Tensor``.

    ``.shape`` / ``.dtype`` / ``.place`` / ``.stop_gradient`` / ``.grad``
    / ``.name`` / ``.persistable``, ``numpy()`` / ``item()`` /
    ``clone()`` / ``detach()``, ``backward()``, ``register_hook()`` and
    the operators (installed by ``paddle_tpu_torch.tensor``).
    """

    name = ""
    persistable = False
    is_leaf_param = False
    _grad_facade = None
    _grad_other = None      # a gradient of another dtype (``grad`` setter)
    _grad_hook = None       # the hook that adds each backward to it

    def __init__(self, data, stop_gradient: bool = True, name: str = ""):
        if isinstance(data, Tensor):
            data = data._t
        if not torch.is_tensor(data):
            data = _as_torch(data, None, current_device())
        if stop_gradient:
            if data.requires_grad:
                data = data.detach()
        elif not data.requires_grad and (data.is_floating_point()
                                         or data.is_complex()):
            data = data.detach().requires_grad_(True)
        self._t = data
        self.name = name
        self.trainable = not stop_gradient

    @classmethod
    def _wrap(cls, t) -> "Tensor":
        """Wrap a torch tensor as it is (its graph and grad state)."""
        out = object.__new__(cls)
        if not torch.is_tensor(t):
            t = torch.as_tensor(t)
        out._t = t
        out.trainable = t.requires_grad
        return out

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def ndim(self) -> int:
        return self._t.dim()

    @property
    def rank(self) -> int:
        return self._t.dim()

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def place(self):
        return place_of(self._t.device)

    @property
    def is_leaf(self) -> bool:
        return self._t.is_leaf

    @property
    def stop_gradient(self) -> bool:
        return not self._t.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._t
        if value:
            if t.requires_grad:
                if t.grad_fn is not None:
                    _cut(t)     # an op may have consumed it already
                self._t = t.detach()
        elif not t.requires_grad and (t.is_floating_point()
                                      or t.is_complex()):
            t.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        g = self._t.grad
        if g is not None and g._is_zerotensor():   # torch's lazy zero
            g = self._t.grad = torch.zeros(g.shape, dtype=g.dtype,
                                           device=g.device)
        if self._grad_other is not None:
            self._fold_grad(self._t)
            g = self._grad_other
        if g is None:
            return None
        f = self._grad_facade
        if f is None or f._t is not g:
            f = Tensor._wrap(g)
            self._grad_facade = f
        return f

    @grad.setter
    def grad(self, value):
        """torch refuses a ``.grad`` whose dtype differs from its leaf's,
        and the reference sets one (``GradScaler`` leaves a bf16
        parameter an f32 gradient).  Such a gradient is held beside the
        leaf in its own dtype, never cast down: the getter returns it,
        ``clear_grad`` drops it.  A post-accumulate hook on the leaf adds
        each later backward's gradient to it as soon as torch has written
        it, as the reference's ``grad + g`` does, so two backwards never
        sum in the leaf's lower dtype first."""
        v = None if value is None else _unwrap(value)
        if v is not None and v.dtype != self._t.dtype:
            self._t.grad = None
            self._grad_other = v
            t = self._t
            if self._grad_hook is None and t.is_leaf and t.requires_grad:
                ref = weakref.ref(self)

                def fold(leaf):
                    f = ref()
                    if f is not None:
                        f._fold_grad(leaf)
                self._grad_hook = t.register_post_accumulate_grad_hook(fold)
        else:
            self._t.grad = v
            self._drop_held_grad()

    def _fold_grad(self, leaf):
        """Adds ``leaf.grad`` (a backward's gradient, in the leaf's dtype)
        to the held gradient in the held dtype, as the reference's
        ``grad + g`` promotes, and clears it from the leaf."""
        g = leaf.grad
        if g is None or self._grad_other is None:
            return
        self._grad_other = self._grad_other + g.to(self._grad_other.dtype)
        leaf.grad = None

    def _drop_held_grad(self):
        self._grad_other = None
        if self._grad_hook is not None:
            self._grad_hook.remove()
            self._grad_hook = None

    @property
    def T(self):
        from ..tensor.linalg import t
        return t(self)

    @property
    def mT(self):
        from ..tensor.manipulation import transpose
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return transpose(self, perm)

    # -- conversion --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 comes back as float32 (numpy has no
        bfloat16), which holds its values exactly."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._t.item()

    def tolist(self):
        return self._t.tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self._t)

    def __len__(self):
        if not self._t.dim():
            raise TypeError("len() of a 0-d tensor")
        return self._t.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- autograd ----------------------------------------------------------
    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._t.detach())
        t.name = self.name
        return t

    def clone(self) -> "Tensor":
        # differentiable copy (the reference's clone keeps the graph)
        return apply_op(torch.clone, self, op_name="clone")

    def backward(self, grad_tensor: Optional["Tensor"] = None,
                 retain_graph: bool = False):
        run_backward([self], [grad_tensor], retain_graph)

    def register_hook(self, hook: Callable) -> Callable:
        """``hook(grad)`` runs on the gradient during backward and may
        return a replacement; returns the remover."""
        if self.stop_gradient:
            return lambda: None
        handle = self._t.register_hook(
            lambda g: _unwrap(hook(Tensor._wrap(g))))
        return handle.remove

    def clear_grad(self):
        self._t.grad = None
        self._drop_held_grad()

    clear_gradient = clear_grad

    def _set_array(self, new):
        """Value replacement (optimizer updates, ``set_value``): the
        facade takes ``new`` as its tensor and keeps its
        ``stop_gradient``."""
        new = _unwrap(new)
        if self._t.requires_grad and not new.requires_grad and (
                new.is_floating_point() or new.is_complex()):
            new = new.detach().requires_grad_(True)
        elif not self._t.requires_grad and new.requires_grad:
            new = new.detach()
        self._t = new
        return self

    def set_value(self, value):
        with torch.no_grad():
            new = _as_torch(_unwrap(value), self._t.dtype, self._t.device)
            if new is _unwrap(value):
                new = new.clone()
        return self._set_array(new)

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both, differentiably."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        for a in args:
            if isinstance(a, (torch.dtype, np.dtype)) or (
                    isinstance(a, str) and a in dtype_mod._NAME_TO_DTYPE):
                dtype = a
            else:
                device = a
        dev = _parse_device(device).device if device is not None else None
        dt = dtype_mod.convert_dtype(dtype)
        return apply_op(lambda x: x.to(device=dev, dtype=dt), self,
                        op_name="to")

    # -- misc --------------------------------------------------------------
    def __repr__(self):
        data = self.numpy()
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n       {data})")

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# op application
# ---------------------------------------------------------------------------

class _AmpOff:
    enabled = False


# AMP: ``paddle_tpu_torch.amp`` installs its thread-local state and its
# cast hook (``amp_cast_inputs``) here, the reference's ``_AMP_CAST_HOOK``;
# while AMP is off ``apply_op`` reads one flag and casts nothing.
_AMP_STATE = _AmpOff()
_AMP_CAST_HOOK = [None]
# static-graph recording (``static/program.py``): while a program
# records, ``apply_op`` hands every op to this hook, which runs it and
# appends (pure_fn, tensor inputs, outputs, op_name) to the program (the
# reference's ``_STATIC_RECORD_HOOK``); with no program recording the
# cost is this one read.
_STATIC_RECORD_HOOK = [None]


def apply_op(fn: Callable, *inputs, op_name: str = "", n_outs: int = 1,
             **kwargs):
    """Run ``fn(*tensors, **kwargs)`` on the inputs' torch tensors and
    wrap what it returns.

    Non-``Tensor`` positional inputs pass through as they are.  torch
    records the graph when grad mode is on and an input requires grad.
    Returns a ``Tensor``, or a tuple of them when ``fn`` returns a tuple
    or list.  ``op_name`` names the op in the NaN/Inf check;
    ``n_outs`` is the reference's argument (the count of outputs comes
    from what ``fn`` returns).  Under ``amp.auto_cast`` the floating
    ``Tensor`` inputs are cast first by the op's list (a cast in the
    graph: the gradient returns in the input's own dtype).  While a
    static program records, the op is also appended to it.
    """
    if _AMP_STATE.enabled:
        cast = _AMP_CAST_HOOK[0](op_name, inputs)
        if _STATIC_RECORD_HOOK[0] is not None:
            # a program records the uncast inputs and replays the casts
            # as part of the op, on the fed and the live values
            fn = _cast_first(fn, inputs, cast)
        else:
            inputs = cast
    if _STATIC_RECORD_HOOK[0] is not None:
        return _STATIC_RECORD_HOOK[0](fn, inputs, kwargs, op_name)
    return wrap_outputs(fn(*[_unwrap(x) for x in inputs], **kwargs),
                        op_name)


def _cast_first(fn, inputs, cast):
    """``fn`` that first casts each positional input to the dtype the
    AMP hook gave it (``cast``: the hook's output for ``inputs``)."""
    dtypes = [None if c is x else c._t.dtype for x, c in zip(inputs, cast)]
    if all(d is None for d in dtypes):
        return fn

    def cast_fn(*args, **kwargs):
        return fn(*[a if d is None else a.to(d)
                    for a, d in zip(args, dtypes)], **kwargs)
    return cast_fn


def wrap_outputs(out, op_name):
    """An op's torch result as a ``Tensor`` (or a tuple of them), after
    the NaN/Inf check when ``FLAGS_check_nan_inf`` is on."""
    if isinstance(out, (tuple, list)):
        outs = tuple(Tensor._wrap(o) for o in out)
        if _FLAGS["FLAGS_check_nan_inf"]:
            _check_nan_inf(op_name, outs)
        return outs
    res = Tensor._wrap(out)
    if _FLAGS["FLAGS_check_nan_inf"]:
        _check_nan_inf(op_name, (res,))
    return res


def tape_snapshot(x: "Tensor") -> "Tensor":
    """The pre-mutation value of ``x``, as an in-place op records it:
    a new facade over x's current tensor (and so its place in the
    graph), leaving ``x`` free to take the op's output."""
    s = Tensor._wrap(x._t)
    s.name = x.name
    return s


def rebind_inplace(x: "Tensor", out: "Tensor") -> "Tensor":
    """Make ``x`` take over ``out``'s tensor (value and graph): the
    in-place op's result.  The op must have run on ``tape_snapshot(x)``
    so the old value stays reachable in the graph."""
    x._t = out._t
    return x


def _check_nan_inf(op_name, tensors):
    """FLAGS_check_nan_inf: one reduction per floating output and a
    single host read for them all."""
    checks = [(~torch.isfinite(t._t.detach())).any() for t in tensors
              if t._t.is_floating_point() or t._t.is_complex()]
    if checks and bool(torch.stack(checks).any()):
        raise FloatingPointError(
            f"NaN/Inf detected in output of op '{op_name}'")


# ---------------------------------------------------------------------------
# cuts: stop_gradient set on a tensor after an op consumed it
# ---------------------------------------------------------------------------
#
# The reference's tape skips every input whose ``stop_gradient`` is set
# when backward runs, so marking a tensor cuts the paths through it even
# in a graph recorded before.  Here the recorded graph is torch's: a cut
# is a hook that zeroes the gradient arriving at the tensor (the values)
# and a mark in its node's metadata (which outputs are cut), so that
# backward can tell which leaves are reached without passing through a
# cut: those alone get a ``.grad``, as in the reference, where the
# others keep ``None``.  The mark counts itself among the live cuts
# while its node lives; with none live, backward walks nothing.

_LIVE_CUTS = [0]
_CUT_KEY = "paddle_tpu_torch.cut"


class _CutMark:
    def __init__(self):
        self.outputs = set()
        _LIVE_CUTS[0] += 1

    def __del__(self):
        _LIVE_CUTS[0] -= 1


def _zero_grad(g):
    return torch.zeros_like(g)


def _cut(t: torch.Tensor):
    """Cut the graph at the non-leaf ``t``.  Returns the cut's remover
    (None when ``t`` was cut already)."""
    md = t.grad_fn.metadata
    mark = md.get(_CUT_KEY)
    if mark is None:
        mark = md[_CUT_KEY] = _CutMark()
    nr = t.output_nr
    if nr in mark.outputs:
        return None
    mark.outputs.add(nr)
    handle = t.register_hook(_zero_grad)

    def remove():
        handle.remove()
        mark.outputs.discard(nr)
        if not mark.outputs and md.get(_CUT_KEY) is mark:
            del md[_CUT_KEY]
    return remove


def _reached(roots, cut_leaves=()):
    """What backward from ``roots`` reaches without passing a cut: the
    leaves ({id: tensor}; none whose id is in ``cut_leaves``) and the
    (id(node), output) pairs of the non-leaf tensors.  ``keep`` holds
    the nodes, so their ids stay theirs."""
    leaves = {id(r): r for r in roots
              if r.grad_fn is None and r.requires_grad}
    edges, keep, seen = set(), [], set()
    stack = [(r.grad_fn, r.output_nr) for r in roots
             if r.grad_fn is not None]
    while stack:
        fn, nr = stack.pop()
        mark = fn.metadata.get(_CUT_KEY)
        if mark is not None and nr in mark.outputs:
            continue
        keep.append(fn)
        edges.add((id(fn), nr))
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        var = getattr(fn, "variable", None)
        if var is not None:      # AccumulateGrad: a leaf
            if id(var) not in cut_leaves:
                leaves[id(var)] = var
            continue
        stack.extend((nxt, k) for nxt, k in fn.next_functions
                     if nxt is not None)
    return leaves, edges, keep


def _is_reached(t: torch.Tensor, reached) -> bool:
    leaves, edges, _ = reached
    if t.grad_fn is None:
        return id(t) in leaves
    return (id(t.grad_fn), t.output_nr) in edges


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def run_backward(tensors: Sequence[Tensor],
                 grad_tensors: Sequence[Optional[Tensor]] = None,
                 retain_graph: bool = False):
    """``torch.autograd.backward`` with the reference's rules: a root
    with ``stop_gradient`` raises and a non-scalar root needs its
    ``grad_tensor``."""
    grad_tensors = grad_tensors or [None] * len(tensors)
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            raise RuntimeError(
                "backward() called on a tensor with stop_gradient=True")
        if g is None:
            if any(d > 1 for d in t.shape) and t.size != 1:
                raise RuntimeError(
                    "grad_tensor must be provided for non-scalar backward()")
            g = torch.ones_like(t._t)
        else:
            g = _as_torch(_unwrap(g), t._t.dtype, t._t.device)
        roots.append(t._t)
        seeds.append(g)
    if not _LIVE_CUTS[0]:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)
        return
    # a cut is live: only the leaves reached around the cuts take a grad
    leaves = list(_reached(roots)[0].values())
    if leaves:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph,
                                inputs=leaves)


# ---------------------------------------------------------------------------
# to_tensor
# ---------------------------------------------------------------------------

def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()
        ).view(torch.bfloat16)
    if arr.dtype == object:
        raise TypeError("to_tensor: data of dtype object")
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _as_torch(data, dtype, device) -> torch.Tensor:
    """``data`` (a torch tensor, numpy array or Python value) as a torch
    tensor of ``dtype`` (None: as it is) on ``device``."""
    if not torch.is_tensor(data):
        if isinstance(data, (list, tuple)) and any(
                isinstance(d, Tensor) for d in data):
            data = [d.numpy() if isinstance(d, Tensor) else d for d in data]
        data = _from_numpy(np.asarray(data))
    return data.to(device=device, dtype=dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor.  A new tensor on ``place`` (the current place
    if None; a ``Tensor`` or torch tensor keeps its own device).  With no
    dtype: Python bools are bool, ints int64, floats the default dtype;
    float64 numpy data becomes the default dtype, other numpy dtypes
    stay as they are."""
    dt = dtype_mod.convert_dtype(dtype)
    dev = _parse_device(place).device if place is not None else None
    if isinstance(data, Tensor):
        data = data._t
    if torch.is_tensor(data):
        with torch.no_grad():
            t = data.detach().to(device=dev or data.device, dtype=dt,
                                 copy=True)
    else:
        dev = dev or current_device()
        if isinstance(data, (bool, int, float, complex)) and dt is None:
            if isinstance(data, bool):
                dt = torch.bool
            elif isinstance(data, int):
                dt = torch.int64
            elif isinstance(data, float):
                dt = dtype_mod.get_default_dtype()
        if isinstance(data, (bool, int, float)):
            # a Python scalar goes straight to torch (the value numpy's
            # float64 path rounds to), which a capture's tracer follows
            return Tensor(torch.tensor(data, dtype=dt, device=dev),
                          stop_gradient=stop_gradient)
        arr = data if isinstance(data, np.ndarray) else None
        if arr is None:
            if isinstance(data, (list, tuple)) and any(
                    isinstance(d, Tensor) for d in data):
                data = [d.numpy() if isinstance(d, Tensor) else d
                        for d in data]
            arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = dtype_mod.get_default_dtype()
        t = _from_numpy(arr).to(device=dev, dtype=dt)
    return Tensor(t, stop_gradient=stop_gradient)
