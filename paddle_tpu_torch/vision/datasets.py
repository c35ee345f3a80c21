"""Vision datasets (the port of ``paddle_tpu/vision/datasets.py``).

Nothing is downloaded: MNIST and friends load from local files when
present (the same cache paths as the reference's), and every dataset
has a synthetic mode (``backend='synthetic'``) drawn with
``np.random.RandomState(seed)`` exactly as the reference draws it, so
both packages hold the same bits.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "SyntheticImages", "DatasetFolder", "ImageFolder", "Flowers",
           "VOC2012"]


class SyntheticImages(Dataset):
    """Deterministic random images + labels; hermetic stand-in."""

    def __init__(self, num_samples=1024, image_shape=(1, 28, 28),
                 num_classes=10, seed=0, transform=None):
        rng = np.random.RandomState(seed)
        self.images = rng.randn(num_samples, *image_shape).astype(np.float32)
        self.labels = rng.randint(0, num_classes,
                                  (num_samples, 1)).astype(np.int64)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if backend == "synthetic" or (image_path is None
                                      and not self._find_local()):
            syn = SyntheticImages(2048 if mode == "train" else 512,
                                  (1, 28, 28), 10,
                                  seed=0 if mode == "train" else 1)
            self.images = syn.images
            self.labels = syn.labels
            return
        image_path = image_path or self._local_file(
            "train-images-idx3-ubyte.gz" if mode == "train"
            else "t10k-images-idx3-ubyte.gz")
        label_path = label_path or self._local_file(
            "train-labels-idx1-ubyte.gz" if mode == "train"
            else "t10k-labels-idx1-ubyte.gz")
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _cache_dir():
        return os.path.expanduser("~/.cache/paddle_tpu/datasets/mnist")

    def _find_local(self):
        f = os.path.join(self._cache_dir(), "train-images-idx3-ubyte.gz")
        return os.path.exists(f)

    def _local_file(self, name):
        return os.path.join(self._cache_dir(), name)

    @staticmethod
    def _read_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        # CHW float in [0,1] — ready for Conv2D without a transform
        return (data.reshape(n, 1, rows, cols).astype(np.float32) / 255.0)

    @staticmethod
    def _read_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64).reshape(-1, 1)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    @staticmethod
    def _cache_dir():
        return os.path.expanduser(
            "~/.cache/paddle_tpu/datasets/fashion-mnist")


class _CifarBase(Dataset):
    n_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        syn = SyntheticImages(2048 if mode == "train" else 512,
                              (3, 32, 32), self.n_classes,
                              seed=0 if mode == "train" else 1)
        self.images = syn.images
        self.labels = syn.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar10(_CifarBase):
    n_classes = 10


class Cifar100(_CifarBase):
    n_classes = 100


# ---------------------------------------------------------------------------
# folder datasets (reference: vision/datasets/folder.py)
# ---------------------------------------------------------------------------

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


def _default_loader(path):
    """numpy-first loader normalized to the repo's [C, H, W] float
    contract: .npy arrays load as stored (assumed CHW); image files
    decode via vision.io (PIL) as HWC and are transposed."""
    if path.endswith(".npy"):
        return np.load(path)
    from .io import image_load
    img = image_load(path)
    arr = np.asarray(img.numpy() if hasattr(img, "numpy") else img)
    if arr.ndim == 2:
        arr = arr[None]          # grayscale -> (1, H, W)
    elif arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
    return arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8 else arr


def _walk_files(root, exts, is_valid_file):
    """Deterministic recursive walk yielding files passing the filter
    (shared by DatasetFolder/ImageFolder). The walk must stay LAZY so
    the dirs[:] mutation actually prunes hidden directories —
    sorted(os.walk(...)) would exhaust the generator before pruning."""
    for base, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if not d.startswith("."))
        for fname in sorted(files):
            path = os.path.join(base, fname)
            ok = is_valid_file(path) if is_valid_file else \
                fname.lower().endswith(exts)
            if ok:
                yield path


class DatasetFolder(Dataset):
    """Generic <root>/<class_x>/<sample> tree (reference:
    folder.py DatasetFolder — classes from subdirectory names, samples
    gathered per class, loaded lazily)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        exts = tuple(e.lower() for e in (extensions or IMG_EXTENSIONS))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"DatasetFolder: no class folders in {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for path in _walk_files(os.path.join(root, c), exts,
                                    is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"DatasetFolder: no files with extensions {exts} under "
                f"{root}")
        self.targets = [t for _, t in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Flat (unlabeled) image folder — returns [sample] like the
    reference (folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        exts = tuple(e.lower() for e in (extensions or IMG_EXTENSIONS))
        self.samples = list(_walk_files(root, exts, is_valid_file))
        if not self.samples:
            raise RuntimeError(f"ImageFolder: no images under {root}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Flowers-102 (reference: vision/datasets/flowers.py). Loads from
    the local cache (~/.cache/paddle_tpu/datasets/flowers: the
    reference's 102flowers.tgz + labels/setid .mat files, pre-extracted
    to images.npy/labels.npy by utils.download tooling) or falls back to
    a deterministic synthetic set in this air-gapped environment."""

    n_classes = 102

    def __init__(self, mode="train", transform=None, download=True,
                 backend=None):
        self.transform = transform
        cache = os.path.expanduser("~/.cache/paddle_tpu/datasets/flowers")
        img_f = os.path.join(cache, f"{mode}_images.npy")
        lab_f = os.path.join(cache, f"{mode}_labels.npy")
        if backend != "synthetic" and os.path.exists(img_f) \
                and os.path.exists(lab_f):  # partial cache -> synthetic
            self.images = np.load(img_f)
            self.labels = np.load(lab_f)
        else:
            syn = SyntheticImages(512 if mode == "train" else 128,
                                  (3, 96, 96), self.n_classes,
                                  seed=7 if mode == "train" else 8)
            self.images, self.labels = syn.images, syn.labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference:
    vision/datasets/voc2012.py — returns (image, label_mask)). Local
    cache or deterministic synthetic masks."""

    def __init__(self, mode="train", transform=None, download=True,
                 backend=None):
        self.transform = transform
        cache = os.path.expanduser("~/.cache/paddle_tpu/datasets/voc2012")
        img_f = os.path.join(cache, f"{mode}_images.npy")
        lab_f = os.path.join(cache, f"{mode}_masks.npy")
        if backend != "synthetic" and os.path.exists(img_f) \
                and os.path.exists(lab_f):  # partial cache -> synthetic
            self.images = np.load(img_f)
            self.masks = np.load(lab_f)
        else:
            n = 256 if mode == "train" else 64
            rng = np.random.default_rng(3 if mode == "train" else 4)
            self.images = rng.random((n, 3, 64, 64)).astype(np.float32)
            # blocky class masks: 21 classes incl. background
            small = rng.integers(0, 21, (n, 8, 8))
            self.masks = np.repeat(np.repeat(small, 8, 1), 8, 2) \
                .astype(np.int64)

    def __getitem__(self, idx):
        img, mask = self.images[idx], self.masks[idx]
        if self.transform:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.images)
