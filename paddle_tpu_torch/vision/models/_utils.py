"""Shared helpers for the model zoo (the port of
``paddle_tpu/vision/models/_utils.py``): ``load_pretrained`` and
``_make_divisible``.

Weights come from local artifacts only: a path, a ``file://`` url, a
registered source that is one of those, or ``<arch>.{pdparams,npz,pth,
pt}`` in ``$PADDLE_TPU_PRETRAINED_HOME`` or the weights cache
(``$PADDLE_TPU_HOME/weights``, by default ``~/.cache/paddle_tpu/
weights``).  Nothing is downloaded: an ``http(s)`` source raises, and
``pretrained=True`` with no artifact raises as the reference does.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

WEIGHTS_HOME = os.path.join(
    os.environ.get("PADDLE_TPU_HOME",
                   os.path.join(os.path.expanduser("~"), ".cache",
                                "paddle_tpu")),
    "weights")

# arch -> (source path-or-file-url, md5-or-None); starts empty, seeded by
# register_pretrained_source()
PRETRAINED_REGISTRY: dict = {}


def register_pretrained_source(arch: str, url: str, md5sum: str | None = None):
    """Register where ``arch``'s weights live (http(s)/file:// url or a
    local path, see get_weights_path_from_url)."""
    PRETRAINED_REGISTRY[arch] = (url, md5sum)


def get_weights_path_from_url(url: str, md5sum: str | None = None) -> str:
    """The local file behind ``url`` (a path or ``file://`` url),
    checked against ``md5sum`` when one is given."""
    path = url[len("file://"):] if url.startswith("file://") else url
    if url.startswith(("http://", "https://")) or not os.path.exists(path):
        raise RuntimeError(
            f"pretrained weights: no local artifact at {url!r}; nothing "
            f"is downloaded: place the file locally and pass its path, or "
            f"seed the cache at {WEIGHTS_HOME}")
    if md5sum and os.path.isfile(path):
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != md5sum:
            raise RuntimeError(f"md5 mismatch for {path} (expected "
                               f"{md5sum})")
    return path


def _local_candidates(arch: str):
    roots = []
    home = os.environ.get("PADDLE_TPU_PRETRAINED_HOME")
    if home:
        roots.append(home)
    roots.append(WEIGHTS_HOME)
    for root in roots:
        for ext in (".pdparams", ".npz", ".pth", ".pt"):
            yield os.path.join(root, arch + ext)


def _read_state_dict(path: str):
    """Load a raw {name: array} mapping from a weights artifact.
    Returns (state, from_torch) — torch-saved dicts store Linear weights
    (out, in) and need the transpose rule in _compat_keys."""
    if os.path.isdir(path):  # archive source: resolve the file inside
        found = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith((".pdparams", ".npz", ".pth", ".pt"))]
        if len(found) != 1:
            raise ValueError(
                f"pretrained archive {path} must contain exactly one "
                f"weights file (.pdparams/.npz/.pth/.pt); found {found}")
        path = found[0]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, False
    if path.endswith((".pth", ".pt")):
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=True)
        for wrap in ("state_dict", "model_state_dict", "model"):
            if isinstance(obj, dict) and isinstance(obj.get(wrap), dict):
                obj = obj[wrap]
                break
        bad = [k for k, v in obj.items() if not hasattr(v, "numpy")]
        if bad:
            raise ValueError(
                f"pretrained artifact {path} holds non-tensor entries "
                f"{bad[:4]}; pass a plain state dict (or a checkpoint "
                f"with a 'state_dict' key)")
        return {k: v.numpy() for k, v in obj.items()}, True
    from ...framework.io import load as io_load
    obj = io_load(path)
    if isinstance(obj, dict):
        obj = {k: _np(v) for k, v in obj.items()}
    if not isinstance(obj, dict):
        raise ValueError(
            f"pretrained artifact {path} did not contain a state dict "
            f"(got {type(obj).__name__})")
    return obj, False


def _np(v):
    """A checkpoint value (a Tensor, a torch tensor or an array) as a
    numpy array; bf16 comes back as float32."""
    v = getattr(v, "_t", v)
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


# torch-convention buffer names -> paddle-convention (BatchNorm)
_TORCH_RENAMES = {"running_mean": "_mean", "running_var": "_variance"}
_STRIP_PREFIXES = ("module.", "model.", "backbone.")


def _compat_keys(raw: dict, own: dict, from_torch: bool = False):
    """Name-compat bridge (vision analog of models/convert.py): strip
    wrapper prefixes, rename torch-convention BN buffers, drop torch
    bookkeeping, and transpose 2-D weights saved in (out, in) layout.
    The transpose is format-driven (torch artifacts transpose every 2-D
    .weight, square or not); for paddle-layout dicts only an unambiguous
    shape mismatch triggers it."""
    out = {}
    for k, v in raw.items():
        for p in _STRIP_PREFIXES:
            # strip only when it actually bridges to a known name — a
            # model may legitimately own a submodule called e.g.
            # 'backbone'
            if (k.startswith(p) and k not in own
                    and k[len(p):] in own):
                k = k[len(p):]
        head, _, leaf = k.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf in _TORCH_RENAMES:
            k = (head + "." if head else "") + _TORCH_RENAMES[leaf]
        arr = _np(v)
        if k in own and arr.ndim == 2:
            want = tuple(own[k].shape)
            if from_torch and leaf == "weight":
                arr = arr.T  # torch Linear stores (out, in)
            elif (tuple(arr.shape) != want
                    and tuple(arr.shape[::-1]) == want):
                arr = arr.T
        out[k] = arr
    return out


def load_pretrained(model, arch: str, pretrained):
    """Hydrate ``model`` from a pretrained-weights artifact, or raise.

    ``pretrained`` may be False/None (no-op), a path/url string, or True —
    which searches $PADDLE_TPU_PRETRAINED_HOME and the WEIGHTS_HOME cache
    for "<arch>.{pdparams,npz,pth,pt}", then the registered source. The
    reference downloads-or-asserts (resnet.py:351-359); silently returning
    random weights is never acceptable, so a miss raises with the searched
    locations."""
    if not pretrained:
        return model
    if isinstance(pretrained, os.PathLike):
        pretrained = os.fspath(pretrained)
    path = None
    if isinstance(pretrained, str):
        path = (pretrained if os.path.exists(pretrained)
                else get_weights_path_from_url(pretrained))
    else:
        searched = []
        for cand in _local_candidates(arch):
            searched.append(cand)
            if os.path.exists(cand):
                path = cand
                break
        if path is None and arch in PRETRAINED_REGISTRY:
            url, md5 = PRETRAINED_REGISTRY[arch]
            path = get_weights_path_from_url(url, md5)
        if path is None:
            raise RuntimeError(
                f"{arch}(pretrained=True): no weights artifact found. "
                f"Searched {searched} and the source registry. Seed one "
                f"with register_pretrained_source('{arch}', <url-or-path>)"
                f", drop '{arch}.pdparams' into $PADDLE_TPU_PRETRAINED_"
                f"HOME, or pass pretrained=<path>.")
    own = model.state_dict()
    raw, from_torch = _read_state_dict(path)
    state = _compat_keys(raw, own, from_torch)
    missing = [k for k in own if k not in state]
    if missing:  # refuse BEFORE mutating the caller's model
        raise RuntimeError(
            f"{arch}: pretrained artifact {path} is missing "
            f"{len(missing)} parameters (e.g. {missing[:4]}); refusing a "
            f"partial hydration")
    bad_shapes = [
        (k, tuple(state[k].shape), tuple(own[k].shape))
        for k in own if tuple(state[k].shape) != tuple(own[k].shape)]
    if bad_shapes:  # also before mutating: set_state_dict raises mid-loop
        raise RuntimeError(
            f"{arch}: pretrained artifact {path} has mismatched shapes "
            f"(e.g. {bad_shapes[:3]}); was it saved for a different "
            f"num_classes/width?")
    model.set_state_dict(state)
    return model


def _make_divisible(v, divisor=8, min_value=None):
    """Round channel counts to multiples of `divisor` without dropping more
    than 10% (the MobileNet paper rule; reference _utils.py:22)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
