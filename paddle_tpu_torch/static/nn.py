"""paddle.static.nn (the port of ``paddle_tpu/static/nn.py``): functional
layer constructors routed to nn.functional (reference analog
python/paddle/static/nn/common.py: fc, conv2d, ...).  They exist so
static-style model code ports; each builds an ephemeral Layer.
"""
from __future__ import annotations

from ..nn import functional as F
from ..nn import Linear, Conv2D, BatchNorm, Embedding
from .control_flow import cond, while_loop, switch_case, case

__all__ = ["fc", "conv2d", "batch_norm", "embedding",
           "cond", "while_loop", "switch_case", "case"]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    in_features = 1
    for d in x.shape[num_flatten_dims:]:
        in_features *= d
    from ..tensor.manipulation import reshape
    # -1 for the leading (batch-like) extent: static programs are built
    # on placeholder batch 1 but replayed at the fed batch size
    flat = reshape(x, [-1, in_features]) if num_flatten_dims == 1 else \
        reshape(x, list(x.shape[:num_flatten_dims]) + [in_features])
    layer = Linear(in_features, size, weight_attr, bias_attr)
    out = layer(flat)
    if activation:
        out = getattr(F, activation)(out)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None, data_format="NCHW"):
    in_channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = Conv2D(in_channels, num_filters, filter_size, stride, padding,
                   dilation, groups, weight_attr=param_attr,
                   bias_attr=bias_attr, data_format=data_format)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-05,  # noqa: A002
               param_attr=None, bias_attr=None, data_layout="NCHW",
               **kwargs):
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = BatchNorm(c, momentum, epsilon, param_attr, bias_attr,
                      data_layout)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,  # noqa: A002
              param_attr=None, dtype="float32"):
    layer = Embedding(size[0], size[1], padding_idx=padding_idx,
                      weight_attr=param_attr)
    return layer(input)


# ---------------------------------------------------------------------------
# common.py long tail: norms, conv variants, parameterized specials
# ---------------------------------------------------------------------------

def _derive_transpose_filter(in_hw, output_size, stride, padding, nd):
    """reference mode: filter_size=None derives the kernel from the
    requested output size (k = out - (in-1)*stride + 2*pad)."""
    st = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    pd = (padding,) * nd if isinstance(padding, int) else tuple(padding)
    osz = (output_size,) * nd if isinstance(output_size, int) \
        else tuple(output_size)
    return tuple(osz[i] - (in_hw[i] - 1) * st[i] + 2 * pd[i]
                 for i in range(nd))


def conv2d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCHW"):
    from ..nn import Conv2DTranspose
    in_c = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    in_hw = input.shape[2:4] if data_format == "NCHW" \
        else input.shape[1:3]
    if filter_size is None:
        if output_size is None:
            raise ValueError(
                "conv2d_transpose needs filter_size or output_size")
        filter_size = _derive_transpose_filter(in_hw, output_size,
                                               stride, padding, 2)
    layer = Conv2DTranspose(in_c, num_filters, filter_size, stride,
                            padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format)
    out = layer(input, output_size=output_size)
    return getattr(F, act)(out) if act else out


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None, data_format="NCDHW"):
    from ..nn import Conv3D
    in_c = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = Conv3D(in_c, num_filters, filter_size, stride, padding,
                   dilation, groups, weight_attr=param_attr,
                   bias_attr=bias_attr, data_format=data_format)
    out = layer(input)
    return getattr(F, act)(out) if act else out


def conv3d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCDHW"):
    from ..nn import Conv3DTranspose
    in_c = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    in_dhw = input.shape[2:5] if data_format == "NCDHW" \
        else input.shape[1:4]
    if filter_size is None:
        if output_size is None:
            raise ValueError(
                "conv3d_transpose needs filter_size or output_size")
        filter_size = _derive_transpose_filter(in_dhw, output_size,
                                               stride, padding, 3)
    layer = Conv3DTranspose(in_c, num_filters, filter_size, stride,
                            padding, dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format)
    out = layer(input, output_size=output_size)
    return getattr(F, act)(out) if act else out


def instance_norm(input, epsilon=1e-05, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    from ..nn import InstanceNorm2D
    layer = InstanceNorm2D(input.shape[1], epsilon=epsilon,
                           weight_attr=param_attr, bias_attr=bias_attr)
    return layer(input)


def group_norm(input, groups, epsilon=1e-05, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import GroupNorm
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = GroupNorm(groups, c, epsilon=epsilon, weight_attr=param_attr,
                      bias_attr=bias_attr, data_format=data_layout)
    out = layer(input)
    return getattr(F, act)(out) if act else out


def layer_norm(input, scale=True, shift=True,  # noqa: A002
               begin_norm_axis=1, epsilon=1e-05, param_attr=None,
               bias_attr=None, act=None, name=None):
    from ..nn import LayerNorm
    shape = list(input.shape[begin_norm_axis:])
    layer = LayerNorm(shape, epsilon=epsilon,
                      weight_attr=param_attr if scale else False,
                      bias_attr=bias_attr if shift else False)
    out = layer(input)
    return getattr(F, act)(out) if act else out


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              summary_decay_0=0.9999999, **kw):
    """reference: data_norm — PS-era normalization by accumulated
    batch statistics WITHOUT scale/shift parameters; here expressed as
    batch_norm with affine off (the statistics-normalization core)."""
    from ..nn import BatchNorm2D, BatchNorm1D
    c = input.shape[1]
    cls = BatchNorm2D if input.ndim == 4 else BatchNorm1D
    layer = cls(c, epsilon=epsilon, weight_attr=False, bias_attr=False)
    out = layer(input)
    return getattr(F, act)(out) if act else out


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import PReLU
    n = 1 if mode == "all" else (
        x.shape[1] if data_format == "NCHW" else x.shape[-1])
    layer = PReLU(num_parameters=n, weight_attr=param_attr,
                  data_format=data_format)
    return layer(x)


def deform_conv2d(x, offset, mask, num_filters, filter_size,  # noqa: A002
                  stride=1, padding=0, dilation=1, groups=1,
                  deformable_groups=1, im2col_step=1, param_attr=None,
                  bias_attr=None, name=None):
    from ..nn.layer.layers import Layer
    from ..nn import initializer as I
    from ..vision.ops import deform_conv2d as _dc
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    helper = Layer()
    w = helper.create_parameter(
        [num_filters, x.shape[1] // groups, k[0], k[1]], attr=param_attr,
        default_initializer=I.XavierUniform())
    b = None
    if bias_attr is not False:
        b = helper.create_parameter([num_filters], attr=bias_attr,
                                    is_bias=True,
                                    default_initializer=I.Constant(0.0))
    return _dc(x, offset, w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=mask)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from ..nn import Bilinear
    layer = Bilinear(x.shape[-1], y.shape[-1], size,
                     weight_attr=param_attr, bias_attr=bias_attr)
    out = layer(x, y)
    return getattr(F, act)(out) if act else out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn import SpectralNorm
    layer = SpectralNorm(weight.shape, dim=dim, power_iters=power_iters,
                         eps=eps)
    return layer(weight)


def row_conv(input, future_context_size, param_attr=None,  # noqa: A002
             act=None):
    """reference: row_conv op (lookahead convolution for streaming
    ASR): out[t] = sum_{k=0..future} x[t+k] * w[k], per feature."""
    import torch

    from ..core.tensor import apply_op
    from ..nn import initializer as I
    from ..nn.layer.layers import Layer
    helper = Layer()
    d = input.shape[-1]
    w = helper.create_parameter(
        [future_context_size + 1, d], attr=param_attr,
        default_initializer=I.XavierUniform())

    def _f(x, wa):
        T = x.shape[1]
        k = wa.shape[0]
        pad = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
        out = sum(pad[:, i:i + T] * wa[i] for i in range(k))
        return out
    out = apply_op(_f, input, w, op_name="row_conv")
    return getattr(F, act)(out) if act else out


_NCE_CALLS = [0]


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """reference: nce_op — noise-contrastive estimation loss with a
    uniform negative sampler (the documented default).  The negatives
    come from a generator seeded by (seed, call count): fresh per call,
    the same for a given call of a run (the reference folds the call
    count into a fixed key; the draws differ from JAX's)."""
    import torch

    from ..core.tensor import apply_op
    from ..nn import initializer as I
    from ..nn.layer.layers import Layer
    helper = Layer()
    d = input.shape[-1]
    w = helper.create_parameter([num_total_classes, d], attr=param_attr,
                                default_initializer=I.XavierUniform())
    b = helper.create_parameter([num_total_classes], attr=bias_attr,
                                is_bias=True,
                                default_initializer=I.Constant(0.0))
    _NCE_CALLS[0] += 1
    call = _NCE_CALLS[0]

    def _f(x, y, wa, ba):
        B = x.shape[0]
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed) * 1_000_003 + call)
        negs = torch.randint(0, num_total_classes, (B, num_neg_samples),
                             generator=gen, device=x.device)
        y = y.reshape(-1).long()
        # a negative colliding with the true label would push that
        # class's logit toward 0 and 1 at once: shift collisions off
        negs = torch.where(negs == y[:, None],
                           (negs + 1) % num_total_classes, negs)
        pos_logit = torch.sum(x * wa[y], -1) + ba[y]
        neg_logit = torch.einsum("bd,bkd->bk", x, wa[negs]) + ba[negs]

        def bce(logit, target):
            return torch.clamp(logit, min=0) - logit * target + \
                torch.log1p(torch.exp(-torch.abs(logit)))
        loss = bce(pos_logit, 1.0) + bce(neg_logit, 0.0).sum(-1)
        return loss.reshape(B, 1)
    return apply_op(_f, input, label, w, b, op_name="nce")


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    from . import py_func as _top_py_func
    return _top_py_func(func, x, out, backward_func)


def sparse_embedding(input, size, padding_idx=None,  # noqa: A002
                     is_test=False, entry=None, table_class=None,
                     param_attr=None, dtype="float32", slot=None):
    """reference: fluid sparse_embedding -- the PS-backed embedding; a
    dense Embedding here, as in the reference when the table fits the
    device (its host-RAM service, distributed/ps/host_embedding.py, is
    ROADMAP A item 6)."""
    return embedding(input, size, is_sparse=True,
                     padding_idx=padding_idx, param_attr=param_attr,
                     dtype=dtype)


__all__ += ["conv2d_transpose", "conv3d", "conv3d_transpose",
            "instance_norm", "group_norm", "layer_norm", "data_norm",
            "prelu", "deform_conv2d", "bilinear_tensor_product",
            "spectral_norm", "row_conv", "nce", "py_func",
            "sparse_embedding"]


from .sequence import (  # noqa: E402,F401
    sequence_conv, sequence_softmax, sequence_pool, sequence_concat,
    sequence_first_step, sequence_last_step, sequence_slice,
    sequence_expand, sequence_expand_as, sequence_pad, sequence_unpad,
    sequence_reshape, sequence_scatter, sequence_enumerate,
    sequence_reverse, StaticRNN)

__all__ += ["sequence_conv", "sequence_softmax", "sequence_pool",
            "sequence_concat", "sequence_first_step",
            "sequence_last_step", "sequence_slice", "sequence_expand",
            "sequence_expand_as", "sequence_pad", "sequence_unpad",
            "sequence_reshape", "sequence_scatter",
            "sequence_enumerate", "sequence_reverse", "StaticRNN"]
