"""Vision ops (the port of ``paddle_tpu/vision/ops.py``): nms /
matrix_nms, box_iou / box_coder, prior_box, yolo_box, roi_align /
roi_pool / psroi_pool, distribute_fpn_proposals, generate_proposals,
deform_conv2d (and the DeformConv2D layer) and yolo_loss.  The detection
ops whose output sizes depend on the data run on the host in numpy, as
the reference's do, and hand back tensors on the current place; the
dense, differentiable ones are torch ops on the input's device.
"""
from __future__ import annotations

import math

import numpy as np

import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import register, _ensure_tensor

__all__ = ["nms", "nms_padded", "multiclass_nms", "box_iou", "roi_align",
           "deform_conv2d", "box_coder", "prior_box", "yolo_box",
           "yolo_loss", "roi_pool", "psroi_pool", "matrix_nms",
           "distribute_fpn_proposals", "generate_proposals",
           "DeformConv2D", "RoIAlign", "RoIPool", "PSRoIPool"]


def _host(t, dtype=None):
    """A tensor argument as a host numpy array."""
    a = _ensure_tensor(t).numpy()
    return a if dtype is None else a.astype(dtype)


def _out(a):
    """A host result as a Tensor on the current place (float64 as
    float32)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return Tensor(np.ascontiguousarray(a))


def box_iou(boxes1, boxes2):
    b1 = _host(boxes1)
    b2 = _host(boxes2)
    area1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    area2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return _out(inter / np.maximum(union, 1e-10))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS — host-side (dynamic output), like the reference op."""
    b = _host(boxes)
    if scores is None:
        s = np.ones(len(b), np.float32)
    else:
        s = _host(scores)
    keep = _greedy_nms_np(b, s, iou_threshold)
    if top_k is not None:
        keep = keep[:top_k]
    return _out(keep)


def nms_padded(boxes, scores, iou_threshold=0.3, max_out=None):
    """Greedy NMS with a fixed-size output.

    Returns (keep_idx int32[max_out], valid bool[max_out]): the first
    count(valid) entries are the kept box indices in score order;
    padding entries have valid False.  The same suppression order as
    ``nms``, as an argmax-select-suppress loop over the IoU matrix on
    the boxes' device, with no host read inside it.
    """
    bx = getattr(boxes, "_t", None)
    bx = torch.as_tensor(np.asarray(boxes)) if bx is None else bx
    sc = getattr(scores, "_t", None)
    sc = torch.as_tensor(np.asarray(scores)) if sc is None else sc
    bx = bx.detach().float()
    n = bx.shape[0]
    m = n if max_out is None else int(max_out)
    area = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
    lt = torch.maximum(bx[:, None, :2], bx[None, :, :2])
    rb = torch.minimum(bx[:, None, 2:], bx[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                              min=1e-10)
    work = sc.detach().float().clone()
    neg = torch.tensor(-math.inf, device=work.device)
    idx, valid = [], []
    for _ in range(m):
        i = torch.argmax(work)
        ok = work[i] > neg
        sup = torch.where(ok & (iou[i] > iou_threshold), neg, work)
        sup[i] = neg
        work = torch.where(ok, sup, work)
        idx.append(i.to(torch.int32))
        valid.append(ok)
    idx = torch.stack(idx) if idx else torch.zeros(0, dtype=torch.int32)
    valid = torch.stack(valid) if valid else torch.zeros(0, dtype=torch.bool)
    if isinstance(boxes, Tensor) or isinstance(scores, Tensor):
        return Tensor._wrap(idx), Tensor._wrap(valid)
    return idx, valid


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    x = _ensure_tensor(x)
    boxes = _ensure_tensor(boxes)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    bn = _host(boxes_num)
    batch_idx = np.repeat(np.arange(len(bn)), bn)

    def _f(feat, bxs):
        h, w = feat.shape[2], feat.shape[3]
        off = 0.5 if aligned else 0.0
        x1 = bxs[:, 0] * spatial_scale - off
        y1 = bxs[:, 1] * spatial_scale - off
        x2 = bxs[:, 2] * spatial_scale - off
        y2 = bxs[:, 3] * spatial_scale - off
        rw = torch.clamp(x2 - x1, min=1e-3)
        rh = torch.clamp(y2 - y1, min=1e-3)
        dev = feat.device
        ys = y1[:, None] + (torch.arange(oh, device=dev) + 0.5)[None, :] \
            * (rh / oh)[:, None]
        xs = x1[:, None] + (torch.arange(ow, device=dev) + 0.5)[None, :] \
            * (rw / ow)[:, None]
        outs = []
        for r in range(bxs.shape[0]):
            fmap = feat[int(batch_idx[r])]  # [C, H, W]
            yy = ys[r][:, None]  # [oh, 1]
            xx = xs[r][None, :]  # [1, ow]
            y0 = torch.clamp(torch.floor(yy).long(), 0, h - 1)
            x0 = torch.clamp(torch.floor(xx).long(), 0, w - 1)
            y1_ = torch.clamp(y0 + 1, 0, h - 1)
            x1_ = torch.clamp(x0 + 1, 0, w - 1)
            wy = torch.clamp(yy - y0, 0, 1)
            wx = torch.clamp(xx - x0, 0, 1)
            v00 = fmap[:, y0[:, 0]][:, :, x0[0, :]]
            v01 = fmap[:, y0[:, 0]][:, :, x1_[0, :]]
            v10 = fmap[:, y1_[:, 0]][:, :, x0[0, :]]
            v11 = fmap[:, y1_[:, 0]][:, :, x1_[0, :]]
            outs.append(v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                        + v10 * wy * (1 - wx) + v11 * wy * wx)
        return torch.stack(outs)
    return apply_op(_f, x, boxes, op_name="roi_align")


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2: the regular conv grid displaced by
    per-position offsets (v2: samples scaled by ``mask``), sampled
    bilinearly by gathers; differentiable through offsets, mask, x and
    weight.

    x: [N, Cin, H, W]; offset: [N, 2*dg*kh*kw, Ho, Wo] with (dy, dx)
    channel pairs; weight: [Cout, Cin//groups, kh, kw];
    mask: [N, dg*kh*kw, Ho, Wo] or None.
    """
    x = _ensure_tensor(x)
    offset = _ensure_tensor(offset)
    weight = _ensure_tensor(weight)
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    ph, pw = (padding, padding) if isinstance(padding, int) \
        else tuple(padding)
    dh, dw = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)
    Cout, Cin_g, kh, kw = weight.shape
    args = [x, offset, weight]
    has_mask = mask is not None
    if has_mask:
        args.append(_ensure_tensor(mask))
    if bias is not None:
        args.append(_ensure_tensor(bias))

    def _f(xa, off, w, *rest):
        m = rest[0] if has_mask else None
        b = rest[-1] if bias is not None else None
        N, Cin, H, W = xa.shape
        Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        dg = deformable_groups
        cpg = Cin // dg    # channels per deform group
        dev = xa.device
        base_i = torch.arange(Ho, device=dev) * sh - ph
        base_j = torch.arange(Wo, device=dev) * sw - pw
        xf = xa.float()
        cols = []  # per (r, s): [N, Cin, Ho, Wo]
        for r in range(kh):
            for s in range(kw):
                kidx = r * kw + s
                per_g = []
                for g_ in range(dg):
                    dy = off[:, 2 * (g_ * kh * kw + kidx)]
                    dx = off[:, 2 * (g_ * kh * kw + kidx) + 1]
                    py = base_i[None, :, None] + r * dh + dy.float()
                    px = base_j[None, None, :] + s * dw + dx.float()
                    y0 = torch.floor(py)
                    x0 = torch.floor(px)
                    wy = py - y0
                    wx = px - x0
                    ch = xf[:, g_ * cpg:(g_ + 1) * cpg].reshape(N, cpg, H * W)
                    pieces = 0.0
                    for (yy, cy) in ((y0, 1 - wy), (y0 + 1, wy)):
                        for (xx, cx) in ((x0, 1 - wx), (x0 + 1, wx)):
                            inb = ((yy >= 0) & (yy <= H - 1)
                                   & (xx >= 0) & (xx <= W - 1))
                            yi = torch.clamp(yy, 0, H - 1).long()
                            xi = torch.clamp(xx, 0, W - 1).long()
                            # the position varies with both output
                            # coordinates: index the flat H*W plane
                            lin = (yi * W + xi).reshape(N, 1, Ho * Wo)
                            v = torch.gather(
                                ch, 2, lin.expand(N, cpg, Ho * Wo)
                            ).reshape(N, cpg, Ho, Wo)
                            pieces = pieces + v * (cy * cx
                                                   * inb.float())[:, None]
                    if m is not None:
                        pieces = pieces * m[:, g_ * kh * kw + kidx,
                                            None].float()
                    per_g.append(pieces)
                cols.append(torch.cat(per_g, 1))
        col = torch.stack(cols, 2)  # [N, Cin, kh*kw, Ho, Wo]
        col = col.reshape(N, groups, Cin // groups, kh * kw, Ho, Wo)
        wg = w.float().reshape(groups, Cout // groups, Cin_g, kh * kw)
        out = torch.einsum("ngckhw,gock->ngohw", col, wg)
        out = out.reshape(N, Cout, Ho, Wo).to(xa.dtype)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
        return out

    return apply_op(_f, *args, op_name="deform_conv2d")


for _n in ["nms", "box_iou", "roi_align"]:
    register(_n, globals()[_n])


def box_coder(prior_box, prior_box_var, target_box, code_type="encode_center_size",
              box_normalized=True, axis=0, name=None):
    """Encode/decode boxes against priors (reference:
    operators/detection/box_coder_op). prior_box: [M, 4] (x1,y1,x2,y2);
    prior_box_var: [M, 4] | [4] | None; encode: target [N, 4] -> [N, M, 4];
    decode: target [N, M, 4] -> [N, M, 4]."""
    pb = _host(prior_box, np.float32)
    tb = _host(target_box, np.float32)
    pbv = None if prior_box_var is None else \
        _host(prior_box_var, np.float32)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        dx = (tcx[:, None] - pcx[None]) / pw[None]
        dy = (tcy[:, None] - pcy[None]) / ph[None]
        dw = np.log(np.abs(tw[:, None] / pw[None]))
        dh = np.log(np.abs(th[:, None] / ph[None]))
        out = np.stack([dx, dy, dw, dh], -1)
        if pbv is not None:
            out = out / (pbv[None] if pbv.ndim == 2 else pbv.reshape(1, 1, 4))
    elif code_type == "decode_center_size":
        if pbv is None:
            var = np.ones((1, 1, 4), np.float32)
        elif pbv.ndim == 1:
            var = pbv.reshape(1, 1, 4)
        else:
            var = pbv[None] if axis == 0 else pbv[:, None]
        if axis == 0:
            pw_, ph_, pcx_, pcy_ = pw[None, :, None], ph[None, :, None], \
                pcx[None, :, None], pcy[None, :, None]
        else:
            pw_, ph_, pcx_, pcy_ = pw[:, None, None], ph[:, None, None], \
                pcx[:, None, None], pcy[:, None, None]
        d = tb * var
        cx = d[..., 0:1] * pw_ + pcx_
        cy = d[..., 1:2] * ph_ + pcy_
        w = np.exp(d[..., 2:3]) * pw_
        h = np.exp(d[..., 3:4]) * ph_
        out = np.concatenate([cx - w / 2, cy - h / 2,
                              cx + w / 2 - norm, cy + h / 2 - norm], -1)
    else:
        raise ValueError(f"unknown code_type {code_type!r}")
    return _out(out)


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior (anchor) boxes (reference: operators/detection/
    prior_box_op). Returns (boxes [H, W, P, 4], variances same shape)."""
    feat = _ensure_tensor(input)
    img = _ensure_tensor(image)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        sizes = []
        if min_max_aspect_ratios_order:
            sizes.append((ms, ms))
            if max_sizes:
                mx = max_sizes[ms_i]
                sizes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                sizes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                sizes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[ms_i]
                sizes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
        boxes.append(sizes)
    per_cell = [wh for group in boxes for wh in group]
    P = len(per_cell)
    cx = (np.arange(fw) + offset) * step_w
    cy = (np.arange(fh) + offset) * step_h
    out = np.zeros((fh, fw, P, 4), np.float32)
    for p, (bw, bh) in enumerate(per_cell):
        out[:, :, p, 0] = (cx[None, :] - bw / 2) / iw
        out[:, :, p, 1] = (cy[:, None] - bh / 2) / ih
        out[:, :, p, 2] = (cx[None, :] + bw / 2) / iw
        out[:, :, p, 3] = (cy[:, None] + bh / 2) / ih
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return _out(out), _out(var)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None,
             scale_x_y=1.0, iou_aware=False, iou_aware_factor=0.5):
    """Decode YOLOv3 head output [N, P*(5+C), H, W] into boxes + scores
    (reference: operators/detection/yolo_box_op)."""
    xa = _host(x, np.float32)
    imgs = _host(img_size)
    N, _, H, W = xa.shape
    P = len(anchors) // 2
    sig0 = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    ioup = None
    if iou_aware:
        # iou-aware head: first P channels are per-anchor IoU logits,
        # the rest is the standard [P, 5+C] block (reference yolo_box_op)
        ioup = sig0(xa[:, :P].reshape(N, P, H, W))
        xa = xa[:, P:]
    xa = xa.reshape(N, P, 5 + class_num, H, W)
    grid_x = np.arange(W).reshape(1, 1, 1, W)
    grid_y = np.arange(H).reshape(1, 1, H, 1)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    bx = (sig(xa[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1) + grid_x) / W
    by = (sig(xa[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1) + grid_y) / H
    aw = np.asarray(anchors[0::2], np.float32).reshape(1, P, 1, 1)
    ah = np.asarray(anchors[1::2], np.float32).reshape(1, P, 1, 1)
    in_w = downsample_ratio * W
    in_h = downsample_ratio * H
    bw = np.exp(xa[:, :, 2]) * aw / in_w
    bh = np.exp(xa[:, :, 3]) * ah / in_h
    conf = sig(xa[:, :, 4])
    if ioup is not None:
        conf = conf ** (1.0 - iou_aware_factor) * ioup ** iou_aware_factor
    cls = sig(xa[:, :, 5:])
    scores = (conf[:, :, None] * cls)
    ih = imgs[:, 0].astype(np.float32).reshape(N, 1, 1, 1)
    iw = imgs[:, 1].astype(np.float32).reshape(N, 1, 1, 1)
    x1 = (bx - bw / 2) * iw
    y1 = (by - bh / 2) * ih
    x2 = (bx + bw / 2) * iw
    y2 = (by + bh / 2) * ih
    if clip_bbox:
        x1 = np.clip(x1, 0, iw - 1)
        y1 = np.clip(y1, 0, ih - 1)
        x2 = np.clip(x2, 0, iw - 1)
        y2 = np.clip(y2, 0, ih - 1)
    boxes = np.stack([x1, y1, x2, y2], -1).reshape(N, -1, 4)
    scores = np.moveaxis(scores, 2, -1).reshape(N, -1, class_num)
    keep = conf.reshape(N, -1) >= conf_thresh
    boxes = boxes * keep[..., None]
    scores = scores * keep[..., None]
    return _out(boxes), _out(scores)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max-pool each ROI into a fixed grid (reference: roi_pool_op)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    feat = _host(x, np.float32)
    bxs = _host(boxes, np.float32)
    bn = _host(boxes_num)
    batch_idx = np.repeat(np.arange(len(bn)), bn)
    C, H, W = feat.shape[1:]
    outs = np.zeros((len(bxs), C, oh, ow), np.float32)
    for r, bx in enumerate(bxs):
        fmap = feat[batch_idx[r]]
        x1 = int(round(bx[0] * spatial_scale))
        y1 = int(round(bx[1] * spatial_scale))
        x2 = int(round(bx[2] * spatial_scale))
        y2 = int(round(bx[3] * spatial_scale))
        rh = max(y2 - y1 + 1, 1)
        rw = max(x2 - x1 + 1, 1)
        for i in range(oh):
            ys = y1 + int(np.floor(i * rh / oh))
            ye = y1 + int(np.ceil((i + 1) * rh / oh))
            ys, ye = np.clip([ys, ye], 0, H)
            for j in range(ow):
                xs = x1 + int(np.floor(j * rw / ow))
                xe = x1 + int(np.ceil((j + 1) * rw / ow))
                xs, xe = np.clip([xs, xe], 0, W)
                if ye > ys and xe > xs:
                    outs[r, :, i, j] = fmap[:, ys:ye, xs:xe].max((1, 2))
    return _out(outs)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive ROI average pooling (reference: psroi_pool_op):
    input channels C = out_c * oh * ow; bin (i, j) reads its own channel
    group."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    feat = _host(x, np.float32)
    bxs = _host(boxes, np.float32)
    bn = _host(boxes_num)
    batch_idx = np.repeat(np.arange(len(bn)), bn)
    C, H, W = feat.shape[1:]
    if C % (oh * ow):
        raise ValueError(f"channels {C} not divisible by {oh}x{ow}")
    out_c = C // (oh * ow)
    outs = np.zeros((len(bxs), out_c, oh, ow), np.float32)
    for r, bx in enumerate(bxs):
        fmap = feat[batch_idx[r]]
        x1 = bx[0] * spatial_scale
        y1 = bx[1] * spatial_scale
        rh = max(bx[3] * spatial_scale - y1, 0.1)
        rw = max(bx[2] * spatial_scale - x1, 0.1)
        for i in range(oh):
            ys = int(np.floor(y1 + i * rh / oh))
            ye = int(np.ceil(y1 + (i + 1) * rh / oh))
            ys, ye = np.clip([ys, ye], 0, H)
            for j in range(ow):
                xs = int(np.floor(x1 + j * rw / ow))
                xe = int(np.ceil(x1 + (j + 1) * rw / ow))
                xs, xe = np.clip([xs, xe], 0, W)
                if ye > ys and xe > xs:
                    grp = (i * ow + j) * out_c
                    outs[r, :, i, j] = fmap[grp:grp + out_c,
                                            ys:ye, xs:xe].mean((1, 2))
    return _out(outs)


def _greedy_nms_np(b, s, thr, normalized=True, eta=1.0):
    """Greedy suppression core shared by nms/multiclass_nms.
    normalized=False adds the reference's +1 pixel offset to areas/
    intersections; eta < 1 adaptively tightens the threshold after each
    kept box (the SSD nms_eta contract)."""
    norm = 0.0 if normalized else 1.0
    order = np.argsort(-s)
    keep = []
    suppressed = np.zeros(len(b), bool)
    areas = (b[:, 2] - b[:, 0] + norm) * (b[:, 3] - b[:, 1] + norm)
    adaptive = thr
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(b[i, 0], b[:, 0])
        yy1 = np.maximum(b[i, 1], b[:, 1])
        xx2 = np.minimum(b[i, 2], b[:, 2])
        yy2 = np.minimum(b[i, 3], b[:, 3])
        inter = np.clip(xx2 - xx1 + norm, 0, None) * \
            np.clip(yy2 - yy1 + norm, 0, None)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-10)
        suppressed |= iou > adaptive
        suppressed[i] = False
        if eta < 1.0 and adaptive > 0.5:
            adaptive *= eta
    return np.asarray(keep, np.int64)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1,
                   keep_top_k=-1, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, return_index=False,
                   return_rois_num=True, rois_num=None, name=None):
    """Per-class greedy NMS + cross-class top-k (reference:
    operators/detection/multiclass_nms_op / multiclass_nms3). Host-side
    like the reference CPU kernel (dynamic output count).

    Batched form: bboxes [N, M, 4], scores [N, C, M]. Dynamic-ROIs form
    (rois_num given): bboxes [M, 4], scores [M, C] with rois_num [N]
    splitting the M rows per image. background_label defaults to 0 like
    the reference (pass -1 to keep every class). Returns (out [K, 6]
    rows of [label, score, x1, y1, x2, y2], optional flat index,
    rois_num [N]).
    """
    bb = _host(bboxes, np.float32)
    sc = _host(scores, np.float32)
    if rois_num is not None:
        rn = _host(rois_num).reshape(-1)
        if bb.ndim != 2 or sc.ndim != 2:
            raise ValueError(
                "multiclass_nms with rois_num expects bboxes [M, 4] and "
                f"scores [M, C]; got {bb.shape} / {sc.shape}")
        starts = np.concatenate([[0], np.cumsum(rn)]).astype(int)
        groups = [(bb[starts[i]:starts[i + 1]],
                   sc[starts[i]:starts[i + 1]].T,  # -> [C, m]
                   starts[i]) for i in range(len(rn))]
    else:
        groups = [(bb[n], sc[n], n * bb.shape[1])
                  for n in range(bb.shape[0])]
    outs, idxs, counts = [], [], []
    for boxes_n, scores_n, base in groups:
        C = scores_n.shape[0]
        dets = []  # (label, score, box, flat_index)
        for c in range(C):
            if c == background_label:
                continue
            cand = np.nonzero(scores_n[c] > score_threshold)[0]
            if cand.size == 0:
                continue
            if nms_top_k > -1 and cand.size > nms_top_k:
                cand = cand[np.argsort(-scores_n[c, cand])[:nms_top_k]]
            keep = _greedy_nms_np(boxes_n[cand], scores_n[c, cand],
                                  nms_threshold, normalized=normalized,
                                  eta=nms_eta)
            for j in cand[keep]:
                dets.append((c, scores_n[c, j], boxes_n[j], base + j))
        dets.sort(key=lambda d: -d[1])
        if keep_top_k > -1:  # reference: 0 keeps nothing, -1 unlimited
            dets = dets[:keep_top_k]
        counts.append(len(dets))
        for c, s, box, fi in dets:
            # box is already a host numpy row here — unpack it directly
            # (a .tolist() per detection reads as a per-iteration sync)
            outs.append([float(c), float(s), *box])
            idxs.append(fi)
    out = _out(np.asarray(outs, np.float32).reshape(-1, 6))
    nums = _out(np.asarray(counts, np.int32))
    index = _out(np.asarray(idxs, np.int64).reshape(-1, 1))
    if return_index:
        return (out, index, nums) if return_rois_num else (out, index)
    return (out, nums) if return_rois_num else out


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0,
               normalized=True, return_index=False, return_rois_num=True,
               name=None):
    """Matrix NMS (SOLOv2; reference: operators/detection/matrix_nms_op):
    parallel soft suppression by decayed IoU instead of greedy removal.
    bboxes [N, M, 4], scores [N, C, M]."""
    bb = _host(bboxes, np.float32)
    sc = _host(scores, np.float32)
    N, C, M = sc.shape
    all_out, all_idx, rois_num = [], [], []
    for n in range(N):
        dets = []
        for c in range(C):
            if c == background_label:
                continue
            mask = sc[n, c] > score_threshold
            idxs = np.nonzero(mask)[0]
            if len(idxs) == 0:
                continue
            s = sc[n, c, idxs]
            order = np.argsort(-s)
            if nms_top_k > 0:
                order = order[:nms_top_k]
            idxs, s = idxs[order], s[order]
            b = bb[n, idxs]
            norm = 0.0 if normalized else 1.0
            area = (b[:, 2] - b[:, 0] + norm) * (b[:, 3] - b[:, 1] + norm)
            lt = np.maximum(b[:, None, :2], b[None, :, :2])
            rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
            wh = np.clip(rb - lt + norm, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            iou = inter / np.maximum(area[:, None] + area[None] - inter,
                                     1e-10)
            iou = np.triu(iou, 1)
            # compensate IoU: for suppressor i, its own max overlap with
            # any higher-ranked box (reference matrix_nms_op kernel);
            # broadcast per ROW (the suppressor), not per column
            iou_cmax = iou.max(0)
            if use_gaussian:
                decay = np.exp((iou_cmax[:, None] ** 2 - iou ** 2)
                               / gaussian_sigma)
                decay = decay.min(0)
            else:
                decay = ((1 - iou)
                         / np.maximum(1 - iou_cmax[:, None], 1e-10)).min(0)
            ds = s * decay
            keep = ds > post_threshold
            for k in np.nonzero(keep)[0]:
                dets.append((c, ds[k], b[k], idxs[k]))
        dets.sort(key=lambda d: -d[1])
        if keep_top_k > -1:  # reference: 0 keeps nothing, -1 unlimited
            dets = dets[:keep_top_k]
        out = np.asarray([[d[0], d[1], *d[2]] for d in dets],
                         np.float32).reshape(-1, 6)
        all_out.append(out)
        all_idx.append(np.asarray([d[3] for d in dets], np.int64))
        rois_num.append(len(dets))
    out = _out(np.concatenate(all_out, 0)
                             if all_out else np.zeros((0, 6), np.float32))
    res = [out]
    if return_index:
        res.append(_out(
            np.concatenate(all_idx) if all_idx else
            np.zeros((0,), np.int64)))
    if return_rois_num:
        res.append(_out(np.asarray(rois_num, np.int32)))
    return tuple(res) if len(res) > 1 else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign each ROI to an FPN level by its scale (reference:
    operators/detection/distribute_fpn_proposals_op). With ``rois_num``
    (per-image counts for a batched roi list) each level's count output
    is itself per-image."""
    rois = _host(fpn_rois, np.float32)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.clip((rois[:, 2] - rois[:, 0] + off)
                            * (rois[:, 3] - rois[:, 1] + off), 0, None))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    if rois_num is not None:
        rn = _host(rois_num).reshape(-1)
        img_of = np.repeat(np.arange(len(rn)), rn)
        n_imgs = len(rn)
    else:
        img_of = np.zeros(len(rois), np.int64)
        n_imgs = 1
    multi_rois, restore = [], np.zeros(len(rois), np.int64)
    nums = []
    cursor = 0
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        # within a level, keep image order (stable: idx is sorted and
        # rois arrive grouped per image)
        multi_rois.append(_out(rois[idx]))
        per_img = np.bincount(img_of[idx], minlength=n_imgs) \
            .astype(np.int32)
        nums.append(_out(per_img))
        restore[idx] = np.arange(cursor, cursor + len(idx))
        cursor += len(idx)
    return multi_rois, _out(restore.reshape(-1, 1)), nums


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposal generation: decode deltas at anchors, clip, filter
    small, NMS (reference: operators/detection/generate_proposals_v2_op).
    Single-image oriented; batches loop."""
    sc = _host(scores, np.float32)
    bd = _host(bbox_deltas, np.float32)
    imgs = _host(img_size, np.float32)
    anc = _host(anchors, np.float32).reshape(-1, 4)
    var = _host(variances, np.float32).reshape(-1, 4)
    N, A, H, W = sc.shape
    out_rois, out_num, out_probs = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = bd[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anc[order], var[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = np.exp(np.clip(v[:, 2] * d[:, 2], None, 10)) * aw
        h = np.exp(np.clip(v[:, 3] * d[:, 3], None, 10)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2,
                          cx + w / 2 - off, cy + h / 2 - off], -1)
        ih, iw = imgs[n, 0], imgs[n, 1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - off)
        keep = ((boxes[:, 2] - boxes[:, 0] + off >= min_size)
                & (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes, s = boxes[keep], s[keep]
        kept = _greedy_nms_np(boxes, s, nms_thresh)
        kept = kept[:post_nms_top_n]
        out_rois.append(boxes[kept])
        out_probs.append(s[kept])
        out_num.append(len(kept))
    rois = _out(np.concatenate(out_rois, 0)
                              if out_rois else np.zeros((0, 4)))
    probs = _out(
        np.concatenate(out_probs, 0).reshape(-1, 1)
        if out_probs else np.zeros((0, 1), np.float32))
    nums = _out(np.asarray(out_num, np.int32))
    if return_rois_num:
        return rois, probs, nums
    return rois, probs


class DeformConv2D:
    """Layer face of deform_conv2d.  Holds weight and bias; offsets (and
    the v2 mask) are inputs.  The weight is drawn uniform in
    +-1/sqrt(fan_in) from the port's generator (the reference draws it
    from a fixed JAX key)."""

    def __new__(cls, in_channels, out_channels, kernel_size, stride=1,
                padding=0, dilation=1, deformable_groups=1, groups=1,
                weight_attr=None, bias_attr=None):
        from ..nn import initializer as I
        from ..nn.layer.layers import Layer

        kh = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        kw = kernel_size if isinstance(kernel_size, int) else kernel_size[1]

        class _DeformConv2D(Layer):
            def __init__(self):
                super().__init__()
                bound = 1.0 / ((in_channels * kh * kw) ** 0.5)
                self.weight = self.create_parameter(
                    [out_channels, in_channels // groups, kh, kw],
                    attr=weight_attr,
                    default_initializer=I.Uniform(-bound, bound))
                self.bias = None if bias_attr is False else \
                    self.create_parameter(
                        [out_channels], attr=bias_attr, is_bias=True,
                        default_initializer=I.Constant(0.0))

            def forward(self, x, offset, mask=None):
                return deform_conv2d(
                    x, offset, self.weight, bias=self.bias, stride=stride,
                    padding=padding, dilation=dilation,
                    deformable_groups=deformable_groups, groups=groups,
                    mask=mask)

        return _DeformConv2D()


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss: per-sample sum of box location (sigmoid-CE
    for x/y, L1 for w/h, scaled by 2 - gw*gh), objectness (best-matching
    anchors positive, IoU > ignore_thresh ignored) and classification
    (sigmoid-CE, optional label smoothing).  Differentiable; the targets
    are scattered to the responsible cells, and zero-area padding boxes
    are dropped.  gt_box is [N, B, 4] (cx, cy, w, h, normalized)."""
    xs = _ensure_tensor(x)
    gb = _ensure_tensor(gt_box)
    gl = _ensure_tensor(gt_label)
    gs = _ensure_tensor(gt_score) if gt_score is not None else None
    P = len(anchor_mask)

    def _f(xa, gbox, glab, *maybe_score):
        dev = xa.device
        aw_all = torch.tensor(anchors[0::2], dtype=torch.float32, device=dev)
        ah_all = torch.tensor(anchors[1::2], dtype=torch.float32, device=dev)
        mask_arr = torch.tensor(anchor_mask, dtype=torch.long, device=dev)
        N, C, H, W = xa.shape
        assert C == P * (5 + class_num), (C, P, class_num)
        in_w = float(downsample_ratio * W)
        in_h = float(downsample_ratio * H)
        xr = xa.reshape(N, P, 5 + class_num, H, W).float()
        tx, ty = xr[:, :, 0], xr[:, :, 1]
        tw, th = xr[:, :, 2], xr[:, :, 3]
        tobj = xr[:, :, 4]
        tcls = xr[:, :, 5:]  # [N, P, class, H, W]
        gbox = gbox.float()
        gx, gy = gbox[..., 0], gbox[..., 1]   # [N, B]
        gw, gh = gbox[..., 2], gbox[..., 3]
        valid = (gw > 0) & (gh > 0)

        # best anchor per gt by shape IoU over all anchors
        gwp = gw[..., None] * in_w   # [N, B, 1] pixels
        ghp = gh[..., None] * in_h
        inter = torch.minimum(gwp, aw_all) * torch.minimum(ghp, ah_all)
        union = gwp * ghp + aw_all * ah_all - inter
        shape_iou = inter / torch.clamp(union, min=1e-9)
        best = torch.argmax(shape_iou, -1)          # [N, B]
        # the responsible slot within this head's anchor_mask (or -1)
        in_mask = best[..., None] == mask_arr          # [N, B, P]
        slot = torch.where(in_mask.any(-1), in_mask.int().argmax(-1),
                           torch.full_like(best, -1))  # [N, B]
        gi = torch.clamp((gx * W).long(), 0, W - 1)
        gj = torch.clamp((gy * H).long(), 0, H - 1)
        ok = (valid & (slot >= 0)).reshape(-1)
        n_idx = torch.arange(N, device=dev)[:, None].expand(gi.shape)
        flat = ((((n_idx * P + slot) * H + gj) * W + gi)).reshape(-1)[ok]
        size = N * P * H * W

        bw = aw_all[best] / in_w   # best anchor size, normalized
        bh = ah_all[best] / in_h
        tx_t = gx * W - gi
        ty_t = gy * H - gj
        tw_t = torch.log(torch.clamp(gw / torch.clamp(bw, min=1e-9),
                                     min=1e-9))
        th_t = torch.log(torch.clamp(gh / torch.clamp(bh, min=1e-9),
                                     min=1e-9))
        box_scale = 2.0 - gw * gh
        score = maybe_score[0].float() if maybe_score \
            else torch.ones_like(gx)

        def scat(vals):
            out = torch.zeros(size, dtype=torch.float32, device=dev)
            out[flat] = vals.reshape(-1)[ok].float()
            return out.reshape(N, P, H, W)

        m_pos = scat(torch.ones_like(gx))            # responsible cells
        sx = scat(tx_t)
        sy = scat(ty_t)
        sw = scat(tw_t)
        sh = scat(th_t)
        sscale = scat(box_scale * score)

        def bce(logit, target):
            return torch.clamp(logit, min=0) - logit * target + \
                torch.log1p(torch.exp(-torch.abs(logit)))

        loss_xy = (bce(tx, sx) + bce(ty, sy)) * sscale * m_pos
        loss_wh = (torch.abs(tw - sw) + torch.abs(th - sh)) \
            * sscale * m_pos

        # objectness: decode the predicted boxes, IoU against every gt;
        # above the threshold and not responsible -> ignored
        grid_x = torch.arange(W, device=dev).reshape(1, 1, 1, W)
        grid_y = torch.arange(H, device=dev).reshape(1, 1, H, 1)
        px = (torch.sigmoid(tx) * scale_x_y - 0.5 * (scale_x_y - 1)
              + grid_x) / W
        py = (torch.sigmoid(ty) * scale_x_y - 0.5 * (scale_x_y - 1)
              + grid_y) / H
        paw = aw_all[mask_arr].reshape(1, P, 1, 1)
        pah = ah_all[mask_arr].reshape(1, P, 1, 1)
        pw = torch.exp(torch.clamp(tw, -10, 10)) * paw / in_w
        ph = torch.exp(torch.clamp(th, -10, 10)) * pah / in_h

        def box_iou_cwh(px, py, pw, ph, gx, gy, gw, gh):
            # [N, P, H, W] pred vs [N, B] gt -> [N, B, P, H, W]
            px, py, pw, ph = (v[:, None] for v in (px, py, pw, ph))
            gx, gy, gw, gh = (v[..., None, None, None]
                              for v in (gx, gy, gw, gh))
            x1 = torch.maximum(px - pw / 2, gx - gw / 2)
            y1 = torch.maximum(py - ph / 2, gy - gh / 2)
            x2 = torch.minimum(px + pw / 2, gx + gw / 2)
            y2 = torch.minimum(py + ph / 2, gy + gh / 2)
            inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
            return inter / torch.clamp(pw * ph + gw * gh - inter, min=1e-9)

        iou = box_iou_cwh(px, py, pw, ph, gx, gy, gw, gh)
        iou = torch.where(valid[..., None, None, None], iou,
                          torch.zeros_like(iou))
        best_iou = iou.amax(1)                      # [N, P, H, W]
        ignore = (best_iou > ignore_thresh) & (m_pos == 0)
        obj_w = (~ignore).float()
        sobj_score = scat(score)
        loss_obj = bce(tobj, m_pos) * obj_w \
            * torch.where(m_pos > 0, sobj_score, torch.ones_like(m_pos))

        # classification at the responsible cells
        smooth = use_label_smooth and class_num > 1
        pos = 1.0 - 1.0 / class_num if smooth else 1.0
        neg = 1.0 / class_num if smooth else 0.0
        onehot = (glab.long()[..., None]
                  == torch.arange(class_num, device=dev)).float()
        y = onehot * pos + (1 - onehot) * neg          # [N, B, class]
        scls = torch.zeros((size, class_num), dtype=torch.float32,
                           device=dev)
        scls[flat] = y.reshape(-1, class_num)[ok]
        scls = scls.reshape(N, P, H, W, class_num).movedim(-1, 2)
        loss_cls = bce(tcls, scls) * m_pos[:, :, None] \
            * sobj_score[:, :, None]

        return (loss_xy.sum((1, 2, 3)) + loss_wh.sum((1, 2, 3))
                + loss_obj.sum((1, 2, 3)) + loss_cls.sum((1, 2, 3, 4)))

    args = (xs, gb, gl) + ((gs,) if gs is not None else ())
    return apply_op(_f, *args, op_name="yolo_loss")


class RoIAlign:
    """Layer wrapper over roi_align (reference: vision/ops.py RoIAlign)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         spatial_scale=self._spatial_scale,
                         aligned=aligned)


class RoIPool:
    """Layer wrapper over roi_pool (reference: vision/ops.py RoIPool)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        spatial_scale=self._spatial_scale)


class PSRoIPool:
    """Layer wrapper over psroi_pool (reference: PSRoIPool)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          spatial_scale=self._spatial_scale)


# reference: vision/ops.py also exposes the image-io pair
from .io import read_file, decode_jpeg  # noqa: E402,F401
__all__ += ["read_file", "decode_jpeg"]
