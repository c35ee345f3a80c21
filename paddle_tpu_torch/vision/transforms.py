"""Vision transforms (the port of ``paddle_tpu/vision/transforms.py``):
numpy preprocessing on the host, with the CHW float output convention.
``resize`` is torch's ``interpolate`` on the host (antialiased when it
shrinks, as ``jax.image.resize`` is), where the reference calls
``jax.image.resize``."""
from __future__ import annotations

import numbers

import numpy as np

from ..core.tensor import Tensor

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "Pad", "to_tensor", "normalize", "resize", "hflip",
           "vflip", "center_crop", "crop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def _as_np(img):
    if isinstance(img, Tensor):
        return img.numpy()
    return np.asarray(img)


def to_tensor(pic, data_format="CHW"):
    arr = _as_np(pic).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    from ..core.tensor import to_tensor as tt
    return tt(arr)


class ToTensor:
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, pic):
        return to_tensor(pic, self.data_format)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _as_np(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (arr - mean) / std
    if isinstance(img, Tensor):
        from ..core.tensor import to_tensor as tt
        return tt(out)
    return out


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


def resize(img, size, interpolation="bilinear"):
    arr = _as_np(img)
    if isinstance(size, int):
        h, w = arr.shape[:2]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    import torch
    import torch.nn.functional as tF
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    t = t[None, None] if arr.ndim == 2 else t.permute(2, 0, 1)[None]
    mode = {"nearest": "nearest-exact", "bilinear": "bilinear",
            "bicubic": "bicubic"}[interpolation]
    kw = {} if interpolation == "nearest" else \
        {"align_corners": False, "antialias": True}
    out = tF.interpolate(t, size=(int(size[0]), int(size[1])), mode=mode,
                         **kw)[0]
    out = out[0] if arr.ndim == 2 else out.permute(1, 2, 0)
    return out.numpy().astype(arr.dtype)


class Resize:
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


def crop(img, top, left, height, width):
    arr = _as_np(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    arr = _as_np(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = (h - th) // 2
    left = (w - tw) // 2
    return crop(arr, top, left, th, tw)


class CenterCrop:
    def __init__(self, size, keys=None):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.padding = padding

    def __call__(self, img):
        arr = _as_np(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        top = np.random.randint(0, h - th + 1)
        left = np.random.randint(0, w - tw + 1)
        return crop(arr, top, left, th, tw)


def hflip(img):
    return _as_np(img)[:, ::-1]


def vflip(img):
    return _as_np(img)[::-1]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _as_np(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return _as_np(img)


class Transpose:
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        arr = _as_np(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = _as_np(img)
        p = self.padding
        if isinstance(p, int):
            cfg = [(p, p), (p, p)]
        elif len(p) == 2:
            cfg = [(p[1], p[1]), (p[0], p[0])]
        else:
            cfg = [(p[1], p[3]), (p[0], p[2])]
        cfg += [(0, 0)] * (arr.ndim - 2)
        mode = {"constant": "constant", "edge": "edge",
                "reflect": "reflect", "symmetric": "symmetric"}[self.mode]
        if mode == "constant":
            return np.pad(arr, cfg, mode=mode, constant_values=self.fill)
        return np.pad(arr, cfg, mode=mode)


# ---------------------------------------------------------------------------
# reference parity: photometric + geometric transform family
# (python/paddle/vision/transforms/transforms.py + functional.py)
# ---------------------------------------------------------------------------

class BaseTransform:
    """reference: transforms.py BaseTransform — the overridable-apply
    protocol (keys routing collapses to the single-image case here;
    subclasses implement _apply_image)."""

    def __init__(self, keys=None):
        self.keys = keys

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, img):
        return self._apply_image(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    """functional.pad: HWC padding with constant/edge/reflect modes."""
    arr = _as_np(img)
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    spec = [(pt, pb), (pl, pr)] + [(0, 0)] * (arr.ndim - 2)
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(arr, spec, mode=mode, **kw)


def adjust_brightness(img, brightness_factor):
    arr = _as_np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1.5 else 1.0
    return np.clip(arr * brightness_factor, 0, hi).astype(_as_np(img).dtype)


def adjust_contrast(img, contrast_factor):
    arr = _as_np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1.5 else 1.0
    # blend with the mean of the grayscale image (pillow semantics)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
    else:
        gray = arr
    mean = gray.mean()
    out = mean + contrast_factor * (arr - mean)
    return np.clip(out, 0, hi).astype(_as_np(img).dtype)


def adjust_saturation(img, saturation_factor):
    arr = _as_np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1.5 else 1.0
    gray = (arr @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    out = gray + saturation_factor * (arr - gray)
    return np.clip(out, 0, hi).astype(_as_np(img).dtype)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) through HSV."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    arr = _as_np(img).astype(np.float32)
    hi = 255.0 if arr.max() > 1.5 else 1.0
    x = arr / hi
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.max(-1)
    mn = x.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    m = d > 1e-12
    rm = m & (mx == r)
    gm = m & (mx == g) & ~rm
    bm = m & ~rm & ~gm
    h[rm] = ((g - b)[rm] / d[rm]) % 6
    h[gm] = (b - r)[gm] / d[gm] + 2
    h[bm] = (r - g)[bm] / d[bm] + 4
    h = h / 6.0
    s = np.where(mx > 1e-12, d / np.maximum(mx, 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], -1) * hi
    return np.clip(out, 0, hi).astype(_as_np(img).dtype)


def to_grayscale(img, num_output_channels=1):
    arr = _as_np(img).astype(np.float32)
    gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return out.astype(_as_np(img).dtype)


def _affine_sample(arr, matrix, fill=0):
    """Inverse-warp HWC by the 2x3 INVERSE affine matrix (output->input
    coords about the image center), nearest sampling."""
    h, w = arr.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xs = xx - cx
    ys = yy - cy
    sx = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2] + cx
    sy = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2] + cy
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    sxi = np.clip(sxi, 0, w - 1)
    syi = np.clip(syi, 0, h - 1)
    out = arr[syi, sxi]
    if arr.ndim == 3:
        out = np.where(valid[..., None], out, fill)
    else:
        out = np.where(valid, out, fill)
    return out.astype(arr.dtype)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """functional.affine — rotate/translate/scale/shear about the
    center (matrix composed the reference way, then inverted for the
    backward warp)."""
    arr = _as_np(img)
    # positive angle = counter-clockwise in IMAGE coordinates (pillow/
    # reference convention); array y points down, so negate
    a = -np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (
        shear if isinstance(shear, (list, tuple)) else (shear, 0.0)))
    # forward matrix: R(angle) * Shear * Scale
    m = np.array([
        [np.cos(a + sy) / max(np.cos(sy), 1e-9), 
         np.cos(a + sy) * np.tan(sx) / max(np.cos(sy), 1e-9)
         - np.sin(a), 0.0],
        [np.sin(a + sy) / max(np.cos(sy), 1e-9),
         np.sin(a + sy) * np.tan(sx) / max(np.cos(sy), 1e-9)
         + np.cos(a), 0.0]], np.float64) * scale
    fwd = np.vstack([m, [0, 0, 1]])
    fwd[0, 2] = translate[0]
    fwd[1, 2] = translate[1]
    inv = np.linalg.inv(fwd)
    return _affine_sample(arr, inv[:2], fill=fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """functional.rotate: counter-clockwise rotation; ``expand`` grows
    the canvas to hold the whole rotated image; ``center`` moves the
    pivot (image-coordinate (x, y), default the center)."""
    arr = _as_np(img)
    h, w = arr.shape[:2]
    if expand:
        a = np.deg2rad(angle)
        new_w = int(np.ceil(abs(w * np.cos(a)) + abs(h * np.sin(a))))
        new_h = int(np.ceil(abs(w * np.sin(a)) + abs(h * np.cos(a))))
        # embed into the bigger canvas first, then rotate about ITS
        # center — every source pixel stays inside
        pt = (new_h - h) // 2
        pl = (new_w - w) // 2
        spec = [(pt, new_h - h - pt), (pl, new_w - w - pl)] +             [(0, 0)] * (arr.ndim - 2)
        arr = np.pad(arr, spec, constant_values=fill)
        return affine(arr, angle, (0, 0), 1.0, (0.0, 0.0), fill=fill)
    if center is not None:
        # conjugate by the pivot shift: T(c) R T(-c) about the default
        # center equals rotation about `center`
        cx, cy = center
        dx = cx - (w - 1) / 2.0
        dy = cy - (h - 1) / 2.0
        a = -np.deg2rad(angle)
        # translation the rotation-about-center formulation needs
        tx = dx - (np.cos(a) * dx - np.sin(a) * dy)
        ty = dy - (np.sin(a) * dx + np.cos(a) * dy)
        return affine(arr, angle, (tx, ty), 1.0, (0.0, 0.0), fill=fill)
    return affine(img, angle, (0, 0), 1.0, (0.0, 0.0), fill=fill)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """functional.perspective — warp by the homography mapping
    startpoints -> endpoints (solved least-squares, inverse-sampled)."""
    arr = _as_np(img)
    A = []
    bv = []
    for (x, y), (u, v) in zip(endpoints, startpoints):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        bv += [u, v]
    coef = np.linalg.lstsq(np.asarray(A, np.float64),
                           np.asarray(bv, np.float64), rcond=None)[0]
    Hm = np.append(coef, 1.0).reshape(3, 3)
    h, w = arr.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = Hm[2, 0] * xx + Hm[2, 1] * yy + Hm[2, 2]
    sx = (Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]) / den
    sy = (Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]) / den
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    sxi = np.clip(sxi, 0, w - 1)
    syi = np.clip(syi, 0, h - 1)
    out = arr[syi, sxi]
    mask = valid[..., None] if arr.ndim == 3 else valid
    return np.where(mask, out, fill).astype(arr.dtype)


def erase(img, i, j, h, w, v, inplace=False):
    """functional.erase — fill the [i:i+h, j:j+w] region with v.
    Accepts HWC arrays or CHW Tensors (the post-ToTensor case)."""
    if isinstance(img, Tensor):
        arr = img.numpy().copy()
        arr[..., i:i + h, j:j + w] = v
        from ..core.tensor import to_tensor as tt
        return tt(arr)
    arr = _as_np(img) if inplace else _as_np(img).copy()
    arr[i:i + h, j:j + w] = v
    return arr


class RandomResizedCrop(BaseTransform):
    """reference: RandomResizedCrop — random area/aspect crop resized
    to `size` (the ImageNet training crop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _as_np(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            log_r = np.log(self.ratio)
            ar = np.exp(np.random.uniform(*log_r))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                patch = arr[top:top + ch, left:left + cw]
                return resize(patch, self.size, self.interpolation)
        return resize(center_crop(arr, min(h, w)), self.size,
                      self.interpolation)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """reference: ColorJitter — apply the four photometric jitters in
    random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill

    def _apply_image(self, img):
        arr = _as_np(img)
        h, w = arr.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0],
                                   self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1],
                                   self.translate[1]) * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        sh = (np.random.uniform(-self.shear, self.shear)
              if isinstance(self.shear, numbers.Number) and self.shear
              else 0.0)
        return affine(img, angle, (tx, ty), sc, (sh, 0.0),
                      fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = _as_np(img)
        h, w = arr.shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        jitter = lambda lo, hi: np.random.randint(lo, hi + 1)  # noqa: E731
        end = [(jitter(0, dx), jitter(0, dy)),
               (w - 1 - jitter(0, dx), jitter(0, dy)),
               (w - 1 - jitter(0, dx), h - 1 - jitter(0, dy)),
               (jitter(0, dx), h - 1 - jitter(0, dy))]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    """reference: RandomErasing — cutout over a random region; operates
    post-ToTensor (CHW Tensor) or on HWC arrays."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = _as_np(img)
        if isinstance(img, Tensor):
            h, w = arr.shape[-2:]
        else:
            h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(*np.log(self.ratio)))
            eh = int(round(np.sqrt(target / ar)))
            ew = int(round(np.sqrt(target * ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                return erase(img, i, j, eh, ew, self.value)
        return img


__all__ += ["BaseTransform", "RandomResizedCrop", "BrightnessTransform",
            "SaturationTransform", "ContrastTransform", "HueTransform",
            "ColorJitter", "RandomAffine", "RandomRotation",
            "RandomPerspective", "Grayscale", "RandomErasing", "pad",
            "affine", "rotate", "perspective", "to_grayscale",
            "adjust_brightness", "adjust_contrast", "adjust_hue",
            "adjust_saturation", "erase"]
