"""Vision functionals: ``affine_grid``, ``grid_sample`` and
``temporal_shift`` (the port of ``paddle_tpu/nn/functional/vision.py``).

``grid_sample`` is the reference's gather and lerp, op for op (torch's
``grid_sample`` differs at the reflection padding's clip): four
gathers of the corners, weighted by the fractional parts.
"""
from __future__ import annotations

import torch

from ...core.tensor import apply_op
from ...ops.registry import register, _ensure_tensor

__all__ = ["affine_grid", "grid_sample", "temporal_shift"]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] → sampling grid [N, H, W, 2]."""
    theta = _ensure_tensor(theta)
    if hasattr(out_shape, "numpy"):
        out_shape = [int(v) for v in out_shape.numpy()]
    N, C, H, W = [int(v) for v in out_shape]

    def _f(th):
        def axis_coords(n):
            if align_corners:
                return torch.linspace(-1.0, 1.0, n, dtype=th.dtype,
                                      device=th.device)
            step = 2.0 / n
            return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                                  dtype=th.dtype, device=th.device)
        gy, gx = torch.meshgrid(axis_coords(H), axis_coords(W),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [H, W, 3]
        return torch.einsum("nij,hwj->nhwi", th, base)
    return apply_op(_f, theta, op_name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W], grid [N, Hg, Wg, 2] (xy in [-1, 1]) →
    [N, C, Hg, Wg]."""
    assert mode in ("bilinear", "nearest")
    assert padding_mode in ("zeros", "border", "reflection")
    x, grid = _ensure_tensor(x), _ensure_tensor(grid)

    def _unnormalize(coord, size):
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    def _reflect(coord, low, high):
        # reflect into [low, high]; a size-1 dim has span 0
        span = high - low
        if span <= 0:
            return torch.full_like(coord, low)
        return torch.abs(torch.remainder(coord - low, 2 * span) - span) \
            + low

    def _f(xa, ga):
        N, C, H, W = xa.shape
        gx = _unnormalize(ga[..., 0], W)          # [N, Hg, Wg]
        gy = _unnormalize(ga[..., 1], H)
        if padding_mode == "border":
            gx = torch.clamp(gx, 0, W - 1)
            gy = torch.clamp(gy, 0, H - 1)
        elif padding_mode == "reflection":
            if align_corners:
                gx = _reflect(gx, 0.0, W - 1.0)
                gy = _reflect(gy, 0.0, H - 1.0)
            else:
                gx = torch.clamp(_reflect(gx, -0.5, W - 0.5), 0, W - 1)
                gy = torch.clamp(_reflect(gy, -0.5, H - 0.5), 0, H - 1)

        def gather(iy, ix):
            iyc = torch.clamp(iy, 0, H - 1)
            ixc = torch.clamp(ix, 0, W - 1)
            flat = (iyc * W + ixc).reshape(N, 1, -1).expand(N, C, -1)
            vals = torch.gather(xa.reshape(N, C, H * W), 2, flat) \
                .reshape(N, C, *iy.shape[1:])
            if padding_mode == "zeros":
                valid = ((iy >= 0) & (iy < H) & (ix >= 0)
                         & (ix < W))[:, None]
                vals = torch.where(valid, vals, torch.zeros_like(vals))
            return vals

        if mode == "nearest":
            return gather(torch.round(gy).long(), torch.round(gx).long())
        x0 = torch.floor(gx)
        y0 = torch.floor(gy)
        wx = (gx - x0)[:, None]
        wy = (gy - y0)[:, None]
        x0i, y0i = x0.long(), y0.long()
        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x0i + 1)
        v10 = gather(y0i + 1, x0i)
        v11 = gather(y0i + 1, x0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy
    return apply_op(_f, x, grid, op_name="grid_sample")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM channel shift along the segment (time) axis."""
    assert data_format in ("NCHW", "NHWC")
    if not 0.0 <= shift_ratio <= 0.5:
        raise ValueError(
            f"temporal_shift: shift_ratio must be in [0, 0.5], got "
            f"{shift_ratio} (the two shifted blocks may not overlap)")
    x = _ensure_tensor(x)

    def _f(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        NT, C, H, W = a.shape
        T = seg_num
        a = a.reshape(NT // T, T, C, H, W)
        fold = int(C * shift_ratio)
        left = torch.cat([a[:, 1:, :fold],
                          torch.zeros_like(a[:, :1, :fold])], 1)
        right = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                           a[:, :-1, fold:2 * fold]], 1)
        out = torch.cat([left, right, a[:, :, 2 * fold:]], 2)
        out = out.reshape(NT, C, H, W)
        if data_format == "NHWC":
            out = out.permute(0, 2, 3, 1)
        return out
    return apply_op(_f, x, op_name="temporal_shift")


for _n in __all__:
    register(_n, globals()[_n])
