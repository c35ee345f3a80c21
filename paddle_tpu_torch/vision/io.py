"""Image IO (the port of ``paddle_tpu/vision/io.py``): host-side decode
with PIL, imported when a function needs it (the card's machine may not
have it), giving the [C, H, W] uint8 tensor contract on the current
place."""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor

__all__ = ["read_file", "decode_jpeg", "image_load"]


def read_file(filename, name=None) -> Tensor:
    with open(filename, "rb") as f:
        data = f.read()
    return Tensor(np.frombuffer(data, np.uint8))


def decode_jpeg(x, mode="unchanged", name=None) -> Tensor:
    """x: 1-D uint8 tensor of encoded bytes -> [C, H, W] uint8."""
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decode_jpeg needs Pillow on the host") from e
    raw = bytes(np.asarray(x.numpy() if isinstance(x, Tensor) else x,
                           np.uint8))
    img = Image.open(_io.BytesIO(raw))
    if mode != "unchanged":
        img = img.convert(mode.upper() if mode != "gray" else "L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return Tensor(np.ascontiguousarray(arr))


def image_load(path, backend=None):
    from PIL import Image
    return Image.open(path)
