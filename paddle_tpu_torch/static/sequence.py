"""Sequence ops + StaticRNN (the static/nn sequence_lod surface; the port
of ``paddle_tpu/static/sequence.py``).

Reference analog: python/paddle/static/nn/sequence_lod.py — variable-
length sequence operators over level-1 LoD tensors — and
fluid/layers/StaticRNN (a per-step sub-block replayed over time).

Convention (the reference's): a level-1 LoD tensor IS a ``(values, lengths)``
pair — ``values [total, ...]`` concatenates every sequence's steps,
``lengths [B]`` gives each sequence's step count (exactly the
information LoD offsets carry). Functions taking a sequence accept that
pair; ``sequence_pad``/``sequence_unpad`` convert to/from the dense
``[B, T, ...]`` + lengths form the rest of the framework prefers.
Ragged bookkeeping runs on the host (numpy): these are
preprocessing-tier ops, as the reference's CPU-only LoD kernels are;
results land on the current place.

StaticRNN records its step block into a sub-Program (the reference
records a sub-Block) and replays it per timestep at call time.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from ..core.tensor import Tensor, to_tensor

__all__ = ["sequence_conv", "sequence_softmax", "sequence_pool",
           "sequence_concat", "sequence_first_step", "sequence_last_step",
           "sequence_slice", "sequence_expand", "sequence_expand_as",
           "sequence_pad", "sequence_unpad", "sequence_reshape",
           "sequence_scatter", "sequence_enumerate", "sequence_reverse",
           "StaticRNN"]


def _np(x):
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


def _pair(x):
    """(values, lengths) -> numpy views; a bare dense tensor counts as
    one sequence per row of length 1? No — reject, the LoD ops need
    lengths."""
    if not (isinstance(x, (tuple, list)) and len(x) == 2):
        raise TypeError(
            "sequence ops take a (values, lengths) pair — the level-1 "
            "LoD tensor of the reference. Convert a padded batch with "
            "sequence_unpad(x, lengths) first.")
    v, ln = x
    va = _np(v)
    la = _np(ln).astype(np.int64).reshape(-1)
    if int(la.sum()) != va.shape[0]:
        raise ValueError(
            f"lengths sum {int(la.sum())} != values rows {va.shape[0]}")
    return va, la


def _wrap(values: np.ndarray, lengths: np.ndarray):
    return (to_tensor(np.ascontiguousarray(values)),
            to_tensor(np.ascontiguousarray(lengths)))


def _offsets(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def _segments(values, lengths):
    off = _offsets(lengths)
    return [values[off[i]:off[i + 1]] for i in range(len(lengths))]


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """(values, lengths) -> (padded [B, T, ...], lengths)."""
    v, ln = _pair(x)
    pv = _np(pad_value)
    T = int(maxlen) if maxlen is not None else int(ln.max()) if len(ln) \
        else 0
    if maxlen is not None and len(ln) and int(ln.max()) > T:
        raise ValueError(
            f"sequence_pad: longest sequence ({int(ln.max())}) exceeds "
            f"maxlen ({T}); the reference op requires maxlen >= every "
            "sequence length — it pads, it does not truncate")
    B = len(ln)
    out = np.empty((B, T) + v.shape[1:], v.dtype)
    out[...] = pv
    for i, seg in enumerate(_segments(v, ln)):
        out[i, :min(len(seg), T)] = seg[:T]
    return to_tensor(out), to_tensor(ln)


def sequence_unpad(x, length, name=None):
    """Dense [B, T, ...] + lengths -> the (values, lengths) pair."""
    xa = _np(x)
    ln = _np(length).astype(np.int64).reshape(-1)
    vals = np.concatenate([xa[i, :ln[i]] for i in range(len(ln))], axis=0) \
        if len(ln) else xa[:0].reshape((0,) + xa.shape[2:])
    return _wrap(vals, ln)


def _seq_meta(x):
    """(tensor values, host lengths, host segment ids) keeping the
    VALUES on the tape — the compute-tier sequence ops must stay
    differentiable (the reference's are real ops with grads)."""
    if not (isinstance(x, (tuple, list)) and len(x) == 2):
        raise TypeError(
            "sequence ops take a (values, lengths) pair — the level-1 "
            "LoD tensor of the reference. Convert a padded batch with "
            "sequence_unpad(x, lengths) first.")
    v, ln = x
    vt = v if isinstance(v, Tensor) else to_tensor(np.asarray(v))
    la = _np(ln).astype(np.int64).reshape(-1)
    if int(la.sum()) != vt.shape[0]:
        raise ValueError(
            f"lengths sum {int(la.sum())} != values rows {vt.shape[0]}")
    ids = np.repeat(np.arange(len(la)), la)
    return vt, la, ids


def sequence_softmax(input, use_cudnn=False, name=None):  # noqa: A002
    """Softmax within each sequence — differentiable (segment ops on
    the tape; only the integer id plan is host-side)."""
    from ..geometric import segment_max, segment_sum
    from ..tensor.manipulation import gather
    from ..tensor.math import exp, subtract, divide

    v, ln, ids = _seq_meta(input)
    idt = to_tensor(ids)
    mx = segment_max(v, idt)
    e = exp(subtract(v, gather(mx, idt)))
    z = segment_sum(e, idt)
    out = divide(e, gather(z, idt))
    return (out, to_tensor(ln))


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0,  # noqa: A002
                  name=None):
    """Per-sequence pooling — differentiable through the values (the
    reference sequence_pool op has a gradient kernel; empty sequences
    yield pad_value like the reference)."""
    from ..geometric import segment_max, segment_mean, segment_sum
    from ..tensor.manipulation import gather
    from ..tensor.math import divide, multiply

    v, ln, ids = _seq_meta(input)
    idt = to_tensor(ids)
    pt = pool_type.lower()
    if pt == "max":
        out = segment_max(v, idt)
    elif pt in ("average", "avg", "mean"):
        out = segment_mean(v, idt)
    elif pt == "sum":
        out = segment_sum(v, idt)
    elif pt == "sqrt":
        scale = 1.0 / np.sqrt(np.maximum(ln, 1)).astype(np.float32)
        out = multiply(segment_sum(v, idt),
                       to_tensor(scale.reshape(-1, 1)))
    elif pt == "first":
        off = _offsets(ln)[:-1]
        out = gather(v, to_tensor(off))
    elif pt == "last":
        off = _offsets(ln)[1:] - 1
        out = gather(v, to_tensor(np.maximum(off, 0)))
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    # segment ops only cover ids that appear: pad trailing empty
    # sequences and overwrite empty rows with pad_value
    B = len(ln)
    if out.shape[0] < B or (ln == 0).any():
        from ..core.tensor import apply_op
        empty = to_tensor(ln == 0)

        def _fix(o, e):
            pad = torch.full((B - o.shape[0],) + tuple(o.shape[1:]),
                             pad_value, dtype=o.dtype, device=o.device)
            f = torch.cat([o, pad], 0)
            return torch.where(e.reshape((-1,) + (1,) * (f.dim() - 1)),
                               torch.tensor(pad_value, dtype=f.dtype,
                                            device=f.device), f)
        out = apply_op(_fix, out, empty, op_name="sequence_pool_pad")
    return out


def sequence_first_step(input, name=None):  # noqa: A002
    return sequence_pool(input, "first")


def sequence_last_step(input, name=None):  # noqa: A002
    return sequence_pool(input, "last")


def sequence_concat(input, name=None):  # noqa: A002
    """Concat several sequence pairs per batch item along time."""
    pairs = [_pair(x) for x in input]
    B = len(pairs[0][1])
    segs_per = [_segments(v, ln) for v, ln in pairs]
    vals, lens = [], []
    for b in range(B):
        parts = [sp[b] for sp in segs_per]
        vals.append(np.concatenate(parts, axis=0))
        lens.append(sum(len(p) for p in parts))
    return _wrap(np.concatenate(vals, axis=0),
                 np.asarray(lens, np.int64))


def sequence_slice(input, offset, length, name=None):  # noqa: A002
    v, ln = _pair(input)
    off = _np(offset).reshape(-1)
    lth = _np(length).reshape(-1)
    vals, lens = [], []
    for seg, o, l in zip(_segments(v, ln), off, lth):
        vals.append(seg[int(o):int(o) + int(l)])
        lens.append(int(l))
    return _wrap(np.concatenate(vals, axis=0),
                 np.asarray(lens, np.int64))


def sequence_expand(x, y, ref_level=-1, name=None):
    """Repeat x's sequences to match y's lengths (the LoD broadcast):
    x sequence i is tiled len_y[i] times when x has one step per item,
    else repeated whole."""
    xv, xl = _pair(x)
    _, yl = _pair(y)
    vals, lens = [], []
    for seg, n in zip(_segments(xv, xl), yl):
        rep = np.concatenate([seg] * int(n), axis=0) if int(n) else \
            seg[:0]
        vals.append(rep)
        lens.append(len(rep))
    return _wrap(np.concatenate(vals, axis=0),
                 np.asarray(lens, np.int64))


def sequence_expand_as(x, y, name=None):
    """Expand each single-step x item to y's per-item length."""
    xv, xl = _pair(x)
    _, yl = _pair(y)
    if not np.all(xl == 1):
        raise ValueError("sequence_expand_as expects one step per item "
                         "in x (the reference's constraint)")
    vals = [np.repeat(seg, int(n), axis=0)
            for seg, n in zip(_segments(xv, xl), yl)]
    return _wrap(np.concatenate(vals, axis=0), np.asarray(yl, np.int64))


def sequence_reshape(input, new_dim, name=None):  # noqa: A002
    v, ln = _pair(input)
    d = v.shape[-1]
    new_lens = (ln * d) // new_dim
    if int((ln * d).sum()) % new_dim:
        raise ValueError("total elements not divisible by new_dim")
    return _wrap(v.reshape(-1, new_dim), new_lens.astype(np.int64))


def sequence_scatter(input, index, updates, name=None):  # noqa: A002
    """Scatter-add updates into a DENSE input at per-sequence offsets:
    index/updates are a sequence pair whose segment i addresses row i
    of input."""
    xa = _np(input).copy()
    iv, il = _pair(index)
    uv, _ = _pair(updates)
    off = _offsets(il)
    for b in range(len(il)):
        idx = iv[off[b]:off[b + 1]].astype(np.int64).reshape(-1)
        upd = uv[off[b]:off[b + 1]]
        np.add.at(xa[b], idx, upd)
    return to_tensor(xa)


def sequence_enumerate(input, win_size, pad_value=0, name=None):  # noqa: A002
    v, ln = _pair(input)
    vals = []
    for seg in _segments(v, ln):
        ids = seg.reshape(-1)
        rows = np.full((len(ids), win_size), pad_value, ids.dtype)
        for k in range(win_size):
            take = len(ids) - k
            if take > 0:
                rows[:take, k] = ids[k:]
        vals.append(rows)
    return _wrap(np.concatenate(vals, axis=0) if vals else
                 v.reshape(0, win_size), ln)


def sequence_reverse(x, name=None):
    v, ln = _pair(x)
    vals = [seg[::-1] for seg in _segments(v, ln)]
    return _wrap(np.concatenate(vals, axis=0) if vals else v, ln)


def sequence_conv(input, num_filters, filter_size=3,  # noqa: A002
                  filter_stride=1, padding=True, padding_start=None,
                  bias_attr=None, param_attr=None, act=None, name=None):
    """Context-window convolution per sequence (sequence_conv op): each
    step sees a window of ``filter_size`` neighboring steps (zero at the
    segment boundary) through one dense projection. Differentiable in
    the values, weight, and bias — only the integer window plan is
    host-side."""
    from ..core.tensor import apply_op
    from ..nn import initializer as I
    from ..nn.layer.layers import Layer

    vt, ln, _ids = _seq_meta(input)
    d = vt.shape[-1]
    helper = Layer()
    w = helper.create_parameter([filter_size * d, num_filters],
                                attr=param_attr,
                                default_initializer=I.XavierUniform())
    b = None
    if bias_attr is not False:
        b = helper.create_parameter([num_filters], attr=bias_attr,
                                    is_bias=True,
                                    default_initializer=I.Constant(0.0))
    start = padding_start if padding_start is not None \
        else -(filter_size // 2)
    # host-side window plan: absolute source row per (step, tap), with
    # out-of-segment taps masked
    total = int(ln.sum())
    off = _offsets(ln)
    pos = np.concatenate([np.arange(n) for n in ln]) if total else \
        np.zeros(0, np.int64)
    base = np.repeat(off[:-1], ln)
    seg_len = np.repeat(ln, ln)
    idx = np.zeros((total, filter_size), np.int64)
    mask = np.zeros((total, filter_size), np.float32)
    for k in range(filter_size):
        rel = pos + start + k
        ok = (rel >= 0) & (rel < seg_len)
        idx[:, k] = np.where(ok, base + np.clip(rel, 0, None), 0)
        mask[:, k] = ok
    def _f(va, wa, *mb):
        idx_t = torch.as_tensor(idx, device=va.device)
        mask_t = torch.as_tensor(mask, device=va.device, dtype=va.dtype)
        ctx = torch.cat(
            [va[idx_t[:, k]] * mask_t[:, k:k + 1]
             for k in range(filter_size)], dim=-1)
        o = ctx @ wa
        return o + mb[0] if mb else o

    args = [vt, w] + ([b] if b is not None else [])
    out = apply_op(_f, *args, op_name="sequence_conv")
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return (out, to_tensor(ln))


class StaticRNN:
    """reference: fluid/layers StaticRNN — record the per-step block
    once (into a sub-Program, the reference's sub-Block) and replay it
    over every timestep of the [T, B, ...] inputs at call time."""

    def __init__(self, name=None):
        self._prog = None
        self._inputs: List[Tuple[Tensor, np.ndarray]] = []
        self._mems: List[List] = []   # [placeholder, init, new_value]
        self._outputs: List[Tensor] = []

    @contextlib.contextmanager
    def step(self):
        from .program import Program, program_guard
        self._prog = Program()
        with program_guard(self._prog):
            yield self

    def step_input(self, x):
        xa = _np(x)
        ph = to_tensor(xa[0])
        self._prog._add_feed(f"__rnn_in{len(self._inputs)}", ph)
        self._inputs.append((ph, xa))
        return ph

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        if init is not None:
            arr = _np(init)
        else:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            b = (_np(batch_ref).shape[init_batch_dim_idx]
                 if batch_ref is not None else 1)
            dims = [b if d in (-1, None) else d for d in shape]
            arr = np.full(dims, init_value, np.float32)
        ph = to_tensor(arr)
        self._prog._add_feed(f"__rnn_mem{len(self._mems)}", ph)
        self._mems.append([ph, arr, None])
        return ph

    def update_memory(self, mem, new):
        for slot in self._mems:
            if slot[0] is mem:
                slot[2] = new
                return
        raise ValueError("update_memory: unknown memory tensor")

    def step_output(self, o):
        self._outputs.append(o)

    output = step_output

    def __call__(self):
        if not self._inputs:
            raise RuntimeError("StaticRNN: no step_input was declared")
        T = self._inputs[0][1].shape[0]
        mem_vals = [to_tensor(slot[1])._t for slot in self._mems]
        collected = [[] for _ in self._outputs]
        with torch.no_grad():
            for t in range(T):
                env = {}
                for ph, xa in self._inputs:
                    env[id(ph)] = to_tensor(xa[t])._t
                for slot, mv in zip(self._mems, mem_vals):
                    env[id(slot[0])] = mv
                # captured parameters / constants bind their live tensors
                for cap in self._prog._captured():
                    env.setdefault(id(cap), cap._t)
                env = self._prog._replay(env)
                for i, o in enumerate(self._outputs):
                    collected[i].append(env[id(o)])
                mem_vals = [env[id(slot[2])] if slot[2] is not None else mv
                            for slot, mv in zip(self._mems, mem_vals)]
        outs = [Tensor._wrap(torch.stack(c)) for c in collected]
        return outs[0] if len(outs) == 1 else outs
