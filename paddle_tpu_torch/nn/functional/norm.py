"""Normalization functionals (the port of
``paddle_tpu/nn/functional/norm.py``): the reference's compositions
(population variance, ``(x - mean) * rsqrt(var + eps)``) in torch ops."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor, apply_op
from ...ops.registry import register, _ensure_tensor

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "rms_norm"]


def _var(a, dims, keepdim=False):
    return torch.var(a, dim=dims, correction=0, keepdim=keepdim)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    x = _ensure_tensor(x)
    ch_axis = x.ndim - 1 if data_format.endswith("C") and x.ndim > 2 else 1
    if x.ndim == 2:
        ch_axis = 1
    reduce_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    use_batch_stats = training and not use_global_stats

    args = [x]
    for t in (weight, bias):
        if t is not None:
            args.append(_ensure_tensor(t))
    has_w = weight is not None
    has_b = bias is not None
    rm_t = _ensure_tensor(running_mean)
    rv_t = _ensure_tensor(running_var)
    args += [rm_t, rv_t]

    def _f(a, *rest):
        i = 0
        w = rest[i] if has_w else None
        i += 1 if has_w else 0
        b = rest[i] if has_b else None
        i += 1 if has_b else 0
        rm, rv = rest[i], rest[i + 1]
        if use_batch_stats:
            mean = torch.mean(a, dim=reduce_axes)
            var = _var(a, reduce_axes)
        else:
            mean, var = rm, rv
        shape = [1] * a.dim()
        shape[ch_axis] = a.shape[ch_axis]
        out = (a - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + epsilon)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out, mean, var
    out, batch_mean, batch_var = apply_op(_f, *args, op_name="batch_norm")

    # the running statistics update in place, from the batch's own
    # statistics (the unbiased variance)
    if use_batch_stats and isinstance(running_mean, Tensor):
        from ...static.program import record_state_write, recording_program
        if recording_program() is not None:
            # a static build runs on placeholder zeros: the update is
            # recorded (as ops on the replay's batch) and the Executor
            # writes it into the live buffers after each run
            def _upd_var(v, bv, a):
                n = 1
                for ax in reduce_axes:
                    n *= a.shape[ax]
                return momentum * v + (1 - momentum) * (
                    bv * (n / max(n - 1, 1)))
            new_mean = apply_op(
                lambda m, bm: momentum * m + (1 - momentum) * bm,
                rm_t, batch_mean, op_name="bn_update_mean")
            new_var = apply_op(_upd_var, rv_t, batch_var, x,
                               op_name="bn_update_var")
            record_state_write(running_mean, new_mean)
            record_state_write(running_var, new_var)
            return out
        n = 1
        for ax in reduce_axes:
            n *= x.shape[ax]
        with torch.no_grad():
            bm, bv = batch_mean._t.detach(), batch_var._t.detach()
            running_mean._set_array(momentum * rm_t._t
                                    + (1 - momentum) * bm)
            running_var._set_array(momentum * rv_t._t + (1 - momentum)
                                   * (bv * (n / max(n - 1, 1))))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    x = _ensure_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(list(normalized_shape))
    axes = tuple(range(x.ndim - nd, x.ndim))

    args = [x]
    has_w = weight is not None
    has_b = bias is not None
    if has_w:
        args.append(_ensure_tensor(weight))
    if has_b:
        args.append(_ensure_tensor(bias))

    def _f(a, *wb):
        mean = torch.mean(a, dim=axes, keepdim=True)
        var = _var(a, axes, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + epsilon)
        i = 0
        if has_w:
            out = out * wb[i]
            i += 1
        if has_b:
            out = out + wb[i]
        return out
    return apply_op(_f, *args, op_name="layer_norm")


def rms_norm(x, weight=None, epsilon=1e-06, name=None):
    """RMSNorm (the Llama family's norm): float32 statistics, the result
    cast back, then the weight."""
    x = _ensure_tensor(x)
    args = [x]
    if weight is not None:
        args.append(_ensure_tensor(weight))

    def _f(a, *w):
        a32 = a.float()
        ms = torch.mean(a32 * a32, -1, keepdim=True)
        out = (a32 * torch.rsqrt(ms + epsilon)).to(a.dtype)
        if w:
            out = out * w[0]
        return out
    return apply_op(_f, *args, op_name="rms_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  eps=1e-05, data_format="NCHW", name=None):
    x = _ensure_tensor(x)
    axes = tuple(range(2, x.ndim))
    args = [x]
    has_w = weight is not None
    has_b = bias is not None
    if has_w:
        args.append(_ensure_tensor(weight))
    if has_b:
        args.append(_ensure_tensor(bias))

    def _f(a, *wb):
        mean = torch.mean(a, dim=axes, keepdim=True)
        var = _var(a, axes, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + eps)
        shape = [1, a.shape[1]] + [1] * (a.dim() - 2)
        i = 0
        if has_w:
            out = out * wb[i].reshape(shape)
            i += 1
        if has_b:
            out = out + wb[i].reshape(shape)
        return out
    return apply_op(_f, *args, op_name="instance_norm")


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    x = _ensure_tensor(x)
    channels_last = data_format.endswith("C") and data_format != "NCHW" \
        and data_format != "NCDHW"
    args = [x]
    has_w = weight is not None
    has_b = bias is not None
    if has_w:
        args.append(_ensure_tensor(weight))
    if has_b:
        args.append(_ensure_tensor(bias))

    def _f(a, *wb):
        a_t = torch.movedim(a, -1, 1) if channels_last else a
        n, c = a_t.shape[0], a_t.shape[1]
        g = num_groups
        grouped = a_t.reshape((n, g, c // g) + tuple(a_t.shape[2:]))
        axes = tuple(range(2, grouped.dim()))
        mean = torch.mean(grouped, dim=axes, keepdim=True)
        var = _var(grouped, axes, keepdim=True)
        out = ((grouped - mean) * torch.rsqrt(var + epsilon)).reshape(
            a_t.shape)
        shape = [1, c] + [1] * (a_t.dim() - 2)
        i = 0
        if has_w:
            out = out * wb[i].reshape(shape)
            i += 1
        if has_b:
            out = out + wb[i].reshape(shape)
        if channels_last:
            out = torch.movedim(out, 1, -1)
        return out
    return apply_op(_f, *args, op_name="group_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    x = _ensure_tensor(x)
    ch_axis = x.ndim - 1 if data_format.endswith("C") else 1

    def _f(a):
        sq = a * a
        c = a.shape[ch_axis]
        half = size // 2
        pads = [0, 0] * a.dim()
        # torch's pad list runs from the last axis backwards
        pads[2 * (a.dim() - 1 - ch_axis)] = half
        pads[2 * (a.dim() - 1 - ch_axis) + 1] = size - 1 - half
        padded = torch.nn.functional.pad(sq, pads)
        windows = sum(padded.narrow(ch_axis, i, c) for i in range(size))
        div = (k + alpha / size * windows) ** beta
        return a / div
    return apply_op(_f, x, op_name="local_response_norm")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        nrm = torch.sum(torch.abs(a) ** p, axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)
    return apply_op(_f, x, op_name="normalize")


for _n in __all__:
    register(_n, globals()[_n])
