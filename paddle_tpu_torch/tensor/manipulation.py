"""Shape and layout ops (the port of
``paddle_tpu/tensor/manipulation.py``)."""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as TF

from ..core.tensor import Tensor, apply_op, rebind_inplace, tape_snapshot
from ..ops.registry import register, _ensure_tensor

__all__ = [
    "reshape", "reshape_", "flatten", "squeeze", "unsqueeze", "transpose",
    "concat", "stack", "split", "chunk", "unstack", "unbind", "tile",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "flip",
    "rot90", "roll", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "masked_select", "masked_fill", "where", "take_along_axis",
    "put_along_axis", "cast", "slice", "pad", "repeat_interleave",
    "moveaxis", "swapaxes", "as_complex", "as_real", "view", "view_as",
    "atleast_1d", "atleast_2d", "atleast_3d", "unfold", "tensordot",
    "numel", "shard_index", "crop", "fill_diagonal_",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(v) for v in shape.tolist()]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _common(arrs):
    """The tensors in their common dtype (jnp's promotion)."""
    dt = arrs[0].dtype
    for a in arrs[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return [a.to(dt) for a in arrs]


def _index(i):
    return i.long() if i.dtype != torch.bool else i


def reshape(x, shape, name=None):
    x = _ensure_tensor(x)
    shape = _shape_list(shape)
    # paddle semantics: 0 means "copy this dim from input"
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return apply_op(lambda a: a.reshape(shape), x, op_name="reshape")


def reshape_(x, shape, name=None):
    return rebind_inplace(x, reshape(tape_snapshot(x), shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _ensure_tensor(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    new_shape = x.shape[:s] + [-1] + x.shape[e + 1:]
    return apply_op(lambda a: a.reshape(new_shape), x, op_name="flatten")


def squeeze(x, axis=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(ax % a.dim() for ax in axes if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a
    return apply_op(_f, x, op_name="squeeze")


def unsqueeze(x, axis, name=None):
    x = _ensure_tensor(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [int(a.item()) if isinstance(a, Tensor) else int(a) for a in axes]

    def _f(a):
        out = a
        for ax in sorted(axes):
            out = torch.unsqueeze(out, ax)
        return out
    return apply_op(_f, x, op_name="unsqueeze")


def transpose(x, perm, name=None):
    x = _ensure_tensor(x)
    perm = [int(p) for p in perm]
    return apply_op(lambda a: a.permute(perm), x, op_name="transpose")


def moveaxis(x, source, destination, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.movedim(a, source, destination), x,
                    op_name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.swapaxes(a, axis0, axis1), x,
                    op_name="swapaxes")


def concat(x, axis=0, name=None):
    tensors = [_ensure_tensor(t) for t in x]
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_op(lambda *arrs: torch.cat(_common(arrs), axis), *tensors,
                    op_name="concat")


def stack(x, axis=0, name=None):
    tensors = [_ensure_tensor(t) for t in x]
    return apply_op(lambda *arrs: torch.stack(_common(arrs), axis), *tensors,
                    op_name="stack")


def split(x, num_or_sections, axis=0, name=None):
    x = _ensure_tensor(x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            from ..core.errors import InvalidArgumentError
            raise InvalidArgumentError(
                f"paddle.split: dimension {dim} at axis {axis} is not "
                f"divisible by num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        n_unknown = builtins.sum(1 for s in sizes if s < 0)
        if n_unknown:
            known = builtins.sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(apply_op(lambda a: tuple(torch.split(a, sizes, axis)), x,
                         op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unstack(x, axis=0, num=None, name=None):
    x = _ensure_tensor(x)
    return list(apply_op(lambda a: tuple(torch.unbind(a, axis)), x,
                         op_name="unstack"))


def unbind(x, axis=0):
    return unstack(x, axis)


def tile(x, repeat_times, name=None):
    x = _ensure_tensor(x)
    reps = _shape_list(repeat_times)
    return apply_op(lambda a: torch.tile(a, reps), x, op_name="tile")


def expand(x, shape, name=None):
    x = _ensure_tensor(x)
    shape = _shape_list(shape)
    xs = x.shape
    full = list(shape)
    off = len(full) - len(xs)
    for i, s in enumerate(full):
        if s == -1:
            full[i] = xs[i - off] if i >= off else 1
    return apply_op(lambda a: torch.broadcast_to(a, full), x,
                    op_name="expand")


def expand_as(x, y, name=None):
    return expand(x, _ensure_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    tensors = [_ensure_tensor(t) for t in inputs]
    outs = apply_op(lambda *arrs: tuple(torch.broadcast_tensors(*arrs)),
                    *tensors, op_name="broadcast_tensors")
    return list(outs)


def flip(x, axis, name=None):
    x = _ensure_tensor(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda a: torch.flip(a, tuple(axes)), x, op_name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.rot90(a, k, tuple(axes)), x,
                    op_name="rot90")


def roll(x, shifts, axis=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if axis is None:
            return torch.roll(a, shifts)
        return torch.roll(a, shifts, axis)
    return apply_op(_f, x, op_name="roll")


def gather(x, index, axis=0, name=None):
    x, index = _ensure_tensor(x), _ensure_tensor(index)
    if isinstance(axis, Tensor):
        axis = int(axis.item())

    def _f(a, i):
        i = i.long()
        if i.dim() > 1:
            i = i.reshape(-1)
        if i.dim() == 0:
            return torch.index_select(a, axis, i.reshape(1)).squeeze(axis)
        return torch.index_select(a, axis, i)
    return apply_op(_f, x, index, op_name="gather")


def gather_nd(x, index, name=None):
    x, index = _ensure_tensor(x), _ensure_tensor(index)
    return apply_op(lambda a, idx: a[tuple(idx.long().unbind(-1))], x, index,
                    op_name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    x = _ensure_tensor(x)
    index = _ensure_tensor(index)
    updates = _ensure_tensor(updates)

    def _f(a, idx, upd):
        idx = (idx.reshape(-1).long(),)
        upd = upd.to(a.dtype)
        if overwrite:
            return a.index_put(idx, upd)
        zeroed = a.index_put(idx, torch.zeros_like(upd))
        return zeroed.index_put(idx, upd, accumulate=True)
    return apply_op(_f, x, index, updates, op_name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    return rebind_inplace(x, scatter(tape_snapshot(x), index, updates,
                                     overwrite))


def scatter_nd(index, updates, shape, name=None):
    index = _ensure_tensor(index)
    updates = _ensure_tensor(updates)
    shape = _shape_list(shape)

    def _f(idx, upd):
        z = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
        return z.index_put(tuple(idx.long().unbind(-1)), upd,
                           accumulate=True)
    return apply_op(_f, index, updates, op_name="scatter_nd")


def scatter_nd_add(x, index, updates, name=None):
    x = _ensure_tensor(x)
    index = _ensure_tensor(index)
    updates = _ensure_tensor(updates)
    return apply_op(lambda a, idx, upd: a.index_put(
        tuple(idx.long().unbind(-1)), upd.to(a.dtype), accumulate=True),
        x, index, updates, op_name="scatter_nd_add")


def index_select(x, index, axis=0, name=None):
    x, index = _ensure_tensor(x), _ensure_tensor(index)
    return apply_op(lambda a, i: torch.index_select(a, axis, i.long()),
                    x, index, op_name="index_select")


def index_sample(x, index):
    x, index = _ensure_tensor(x), _ensure_tensor(index)
    return apply_op(lambda a, i: torch.gather(a, 1, i.long()),
                    x, index, op_name="index_sample")


def index_add(x, index, axis, value, name=None):
    x, index, value = (_ensure_tensor(x), _ensure_tensor(index),
                       _ensure_tensor(value))
    return apply_op(lambda a, i, v: torch.index_add(a, axis, i.long(),
                                                    v.to(a.dtype)),
                    x, index, value, op_name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    x = _ensure_tensor(x)
    value = _ensure_tensor(value)
    idx_tensors = [_ensure_tensor(i) for i in indices]

    def _f(a, v, *idxs):
        return a.index_put(tuple(_index(i) for i in idxs), v.to(a.dtype),
                           accumulate=accumulate)
    return apply_op(_f, x, value, *idx_tensors, op_name="index_put")


def masked_select(x, mask, name=None):
    x, mask = _ensure_tensor(x), _ensure_tensor(mask)
    return apply_op(lambda a, m: torch.masked_select(a, m.bool()), x, mask,
                    op_name="masked_select")


def masked_fill(x, mask, value, name=None):
    x, mask = _ensure_tensor(x), _ensure_tensor(mask)
    v = value._t.detach() if isinstance(value, Tensor) else value
    return apply_op(lambda a, m: torch.where(
        m.bool(), torch.as_tensor(v, dtype=a.dtype, device=a.device), a),
        x, mask, op_name="masked_fill")


def where(condition, x=None, y=None, name=None):
    condition = _ensure_tensor(condition)
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition, as_tuple=True)
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda c, a, b: torch.where(c.bool(), *_common([a, b])),
                    condition, x, y, op_name="where")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices = _ensure_tensor(arr), _ensure_tensor(indices)
    return apply_op(lambda a, i: torch.take_along_dim(a, i.long(), axis),
                    arr, indices, op_name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    arr, indices = _ensure_tensor(arr), _ensure_tensor(indices)
    values = _ensure_tensor(values)

    def _f(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v, i.shape).to(a.dtype)
        if reduce == "assign":
            return torch.scatter(a, axis, i, v)
        if reduce == "add":
            return torch.scatter_add(a, axis, i, v)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(a, axis, i, v, "prod")
        raise ValueError(f"unsupported reduce {reduce}")
    return apply_op(_f, arr, indices, values, op_name="put_along_axis")


def cast(x, dtype):
    from ..core import dtype as dtype_mod
    x = _ensure_tensor(x)
    dt = dtype_mod.convert_dtype(dtype)
    return apply_op(lambda a: a.to(dt), x, op_name="cast")


def _int(s):
    return int(s.item()) if isinstance(s, Tensor) else int(s)


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    x = _ensure_tensor(x)

    def _f(a):
        out = a
        for ax, st, en in zip(axes, starts, ends):
            n = a.shape[ax]
            st_, en_ = _int(st), _int(en)
            st_ = n + st_ if st_ < 0 else st_
            en_ = n + en_ if en_ < 0 else en_
            en_ = builtins.min(en_, n)
            out = out.narrow(ax, st_, builtins.max(en_ - st_, 0))
        return out
    return apply_op(_f, x, op_name="slice")


def crop(x, shape=None, offsets=None, name=None):
    x = _ensure_tensor(x)
    shape = _shape_list(shape)
    offsets = [0] * x.ndim if offsets is None else _shape_list(offsets)
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    # lax.dynamic_slice clamps each start so the window fits
    starts = [builtins.min(builtins.max(o, 0), n - s)
              for o, s, n in zip(offsets, shape, x.shape)]

    def _f(a):
        for ax, (st, s) in enumerate(zip(starts, shape)):
            a = a.narrow(ax, st, s)
        return a
    return apply_op(_f, x, op_name="crop")


def _pad_index(n, lo, hi, mode, device):
    """The source index of every output position along one axis
    (``jnp.pad``'s reflect / edge / wrap)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    period = 2 * (n - 1)               # reflect, without the edge
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    x = _ensure_tensor(x)
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim

    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle nn.functional semantics: pad applies to last len(pad)//2
        # dims ordered from the last spatial dim inward, honoring
        # data_format.
        k = len(pad) // 2
        cfg = [(0, 0)] * nd
        if data_format.endswith("C"):  # NHWC / NDHWC / NLC
            dims = list(range(1, 1 + k))
        else:
            dims = list(range(nd - k, nd))
        for i, d in enumerate(reversed(dims)):
            cfg[d] = (pad[2 * i], pad[2 * i + 1])

    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]

    def _f(a):
        if tmode == "constant":
            flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
            return TF.pad(a, flat, mode="constant", value=value)
        for ax, (lo, hi) in enumerate(cfg):
            if lo or hi:
                a = torch.index_select(
                    a, ax, _pad_index(a.shape[ax], lo, hi, tmode, a.device))
        return a
    return apply_op(_f, x, op_name="pad")


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _ensure_tensor(x)
    reps = repeats._t if isinstance(repeats, Tensor) else repeats

    def _f(a):
        if axis is None:
            return torch.repeat_interleave(a.reshape(-1), reps, 0)
        return torch.repeat_interleave(a, reps, axis)
    return apply_op(_f, x, op_name="repeat_interleave")


def as_complex(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                    op_name="as_complex")


def as_real(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.stack([torch.real(a), torch.imag(a)],
                                          -1), x, op_name="as_real")


def atleast_1d(*inputs, name=None):
    outs = [apply_op(torch.atleast_1d, _ensure_tensor(x),
                     op_name="atleast_1d") for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply_op(torch.atleast_2d, _ensure_tensor(x),
                     op_name="atleast_2d") for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply_op(torch.atleast_3d, _ensure_tensor(x),
                     op_name="atleast_3d") for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``; the window
    axis goes last (paddle's layout)."""
    x = _ensure_tensor(x)
    return apply_op(lambda a: a.unfold(axis % a.dim(), size, step), x,
                    op_name="unfold")


def tensordot(x, y, axes=2, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    if isinstance(axes, Tensor):
        axes = axes.tolist()
    return apply_op(lambda a, b: torch.tensordot(*_common([a, b]), dims=axes),
                    x, y, op_name="tensordot")


def numel(x, name=None):
    x = _ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.size, dtype=torch.int64,
                                     device=x._t.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    input = _ensure_tensor(input)
    shard_size = (index_num + nshards - 1) // nshards

    def _f(a):
        in_shard = torch.floor_divide(a, shard_size) == shard_id
        return torch.where(in_shard, torch.remainder(a, shard_size),
                           torch.full_like(a, ignore_value))
    return apply_op(_f, input, op_name="shard_index")


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    x = _ensure_tensor(x)
    n = builtins.min(x.shape[-2], x.shape[-1])
    idx = torch.arange(n - (offset if offset > 0 else 0), device=x._t.device)
    with torch.no_grad():
        arr = x._t.detach().clone()
        arr[..., idx + builtins.max(-offset, 0),
            idx + builtins.max(offset, 0)] = value
    x._set_array(arr)
    return x


for _n in __all__:
    if _n not in ("reshape_", "view", "view_as"):
        register(_n, globals()[_n])
