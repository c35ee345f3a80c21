"""Op codegen: the machinery over the registry (the port of
``paddle_tpu/ops/codegen.py``; reference analog paddle/phi/api/yaml/
ops.yaml and its generators: api_gen.py, eager_gen.py:192 emitting
<op>_ad_func, python_c_gen.py:87 emitting the CPython wrappers that
become paddle._C_ops.<op>).

The single source is ``ops.registry.OP_LIBRARY`` (name -> Tensor-level
API + torch lowering).  From it this module derives:

- ``export_manifest()``: an ops.yaml-shaped text manifest of every
  registered op (name, Python signature, implementation sites);
- ``fast_op`` (``paddle_tpu_torch/_C_ops.py`` consumes it): the eager
  fast path, the op's torch-level function on raw torch tensors, past
  the ``Tensor`` facade;
- ``parity_cases()``: (name, lowering, numpy_fn, n_params) for every op
  sharing a numpy ufunc's name, the generated sweep;
- ``fused_parity_cases()`` and ``kernel_verify_cases()``: the port's
  kernel wrappers beside their plain versions, and their shape
  contracts checked under fake CUDA tensors (no card needed).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .registry import OP_LIBRARY

__all__ = ["export_manifest", "fast_op", "parity_cases",
           "fused_parity_cases", "kernel_verify_cases", "verify_case"]


def _signature(fn: Callable) -> str:
    try:
        return str(inspect.signature(fn))
    except (TypeError, ValueError):
        return "(...)"


def _impl_site(fn: Callable) -> str:
    mod = getattr(fn, "__module__", "?")
    qual = getattr(fn, "__qualname__", getattr(fn, "__name__", "?"))
    return f"{mod}.{qual}"


def export_manifest(path: Optional[str] = None) -> str:
    """ops.yaml-shaped manifest of the full registered op surface."""
    lines = ["# generated from ops.registry.OP_LIBRARY — do not edit",
             f"# ops: {len(OP_LIBRARY)}", ""]
    for name in sorted(OP_LIBRARY):
        info = OP_LIBRARY[name]
        lines += [f"- op : {name}",
                  f"  args : {_signature(info.fn)}",
                  f"  api : {_impl_site(info.fn)}",
                  f"  lowering : {_impl_site(info.lowering)}",
                  ""]
    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


_FAST_CACHE: Dict[str, Callable] = {}


def fast_op(name: str) -> Callable:
    """The _C_ops fast path: the op's registered torch-level lowering,
    called on raw torch tensors with the facade skipped (the analog of
    the generated eager_api_<op> wrappers).  An op registered without a
    separate lowering runs its Tensor-level API on wrapped inputs; its
    outputs are unwrapped, so the surface is torch in, torch out."""
    fn = _FAST_CACHE.get(name)
    if fn is None:
        info = OP_LIBRARY.get(name)
        if info is None:
            raise AttributeError(f"_C_ops has no op '{name}'")
        fn = _make_fast(info.lowering, info.lowering is info.fn)
        _FAST_CACHE[name] = fn
    return fn


def _make_fast(lowering: Callable, tensor_level: bool) -> Callable:
    from ..core.tensor import Tensor

    def unwrap(out):
        if isinstance(out, Tensor):
            return out._t
        if isinstance(out, (tuple, list)):
            return type(out)(unwrap(o) for o in out)
        return out

    def call(*args, **kw):
        if tensor_level:
            args = [Tensor._wrap(a) if torch.is_tensor(a) else a
                    for a in args]
        return unwrap(lowering(*args, **kw))

    call.__name__ = getattr(lowering, "__name__", "fast_op")
    return call


# numpy names whose paddle semantics differ enough that a blind
# same-name comparison would be wrong — excluded from the generated sweep
_PARITY_SKIP = {
    "round",      # paddle rounds half away from zero; numpy half-to-even
    "empty_like",  # contents undefined — value comparison is meaningless
    "nonzero",    # paddle returns a stacked index tensor, numpy a tuple
    "clip", "all", "any", "amax", "amin", "angle", "cumsum", "cumprod",
    "diff", "dot", "cross", "kron", "outer", "trace", "tril", "triu",
    "repeat", "sort", "argsort", "split", "stack", "squeeze", "take",
    "where", "histogram", "median", "quantile", "nanmedian",
    "nanquantile", "prod", "std", "var", "mean", "sum", "broadcast_to",
    "flip", "roll", "rot90", "moveaxis", "transpose", "reshape",
}


def parity_cases() -> List[Tuple[str, Callable, Callable, int]]:
    """(name, lowering, numpy_fn, n_positional_params) for ops sharing a
    numpy ufunc name — the generated elementwise test sweep."""
    import numpy as np
    cases = []
    for name in sorted(OP_LIBRARY):
        if name in _PARITY_SKIP:
            continue
        np_fn = getattr(np, name, None)
        if np_fn is None or not callable(np_fn):
            continue
        info = OP_LIBRARY[name]
        lowering = info.lowering
        n_params = None
        # a torch builtin's signature can not be read: the Tensor-level
        # API's (same positional operands) stands in
        for fn in (lowering, info.fn):
            try:
                n_params = len([
                    p for p in inspect.signature(fn).parameters.values()
                    if p.default is inspect.Parameter.empty
                    and p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)])
                break
            except (TypeError, ValueError):
                continue
        if n_params in (1, 2):
            cases.append((name, lowering, np_fn, n_params))
    return cases


def _kernel_inputs(seed, B=1, S=256, H=256, I=512, D=128,
                   dtype=torch.float32, device="cpu"):
    """The fused blocks' operands from a numpy seed (the parity cases'
    make_args): x, ln, wq, wk, wv, wo, sin, cos, wg, wu, wd."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        ).to(device=device, dtype=dtype)
    half = D // 2
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))
    ang = np.arange(S, dtype=np.float32)[:, None] * inv[None, :]
    emb = np.concatenate([ang, ang], axis=-1)
    sin = torch.as_tensor(np.sin(emb), device=device)
    cos = torch.as_tensor(np.cos(emb), device=device)
    return dict(x=rnd(B, S, H, scale=0.5), ln=rnd(H, scale=0.1, shift=1.0),
                wq=rnd(H, H, scale=0.05), wk=rnd(H, H, scale=0.05),
                wv=rnd(H, H, scale=0.05), wo=rnd(H, H, scale=0.05),
                sin=sin, cos=cos, wg=rnd(H, I, scale=0.05),
                wu=rnd(H, I, scale=0.05), wd=rnd(I, H, scale=0.05),
                dy=rnd(B, S, H, scale=0.5), D=D)


def fused_parity_cases():
    """(name, wrapper, plain_fn, make_args) for the port's kernel
    wrappers on the decoder blocks' path: the wrapper launches the
    kernel on CUDA tensors (its plain version on CPU ones), ``plain_fn``
    is the plain version, ``make_args(seed, device=, dtype=)`` their
    common positional arguments (the structured counterpart of
    ``parity_cases``; ``chip_smoke.py`` holds the kernels to their plain
    versions on the card)."""
    from . import flash_attention as fa
    from . import fused_blocks as fb
    eps = 1e-6

    def qkv_args(seed, **kw):
        t = _kernel_inputs(seed, **kw)
        return (t["x"], t["ln"], t["wq"], t["wk"], t["wv"], t["sin"],
                t["cos"])

    def epi_args(seed, **kw):
        t = _kernel_inputs(seed, **kw)
        q, k, v = fb._fused_qkv_plain(t["x"], t["ln"], t["wq"], t["wk"],
                                      t["wv"], t["sin"], t["cos"], t["D"],
                                      eps)
        return (q, k, v, t["x"], t["wo"])

    def mlp_args(seed, **kw):
        t = _kernel_inputs(seed, **kw)
        return (t["x"], t["ln"], t["wg"], t["wu"], t["wd"])

    def dx_args(seed, **kw):
        t = _kernel_inputs(seed, **kw)
        return (t["x"], t["ln"], t["wg"], t["wu"], t["wd"], t["dy"])

    def flash_args(seed, device="cpu", dtype=torch.float32, B=1, S=256,
                   H=2, D=128):
        rng = np.random.default_rng(seed)
        return tuple(torch.as_tensor(rng.standard_normal(
            (B, S, H, D)).astype(np.float32)).to(device=device, dtype=dtype)
            for _ in range(3))

    D = 128
    return [
        ("flash_fwd", fa.flash_fwd, fa._flash_fwd_plain, flash_args),
        ("fused_qkv",
         lambda *a: fb.fused_qkv(*a, head_dim=D, eps=eps),
         lambda *a: fb._fused_qkv_plain(*a, D, eps), qkv_args),
        ("fused_attn_epilogue",
         lambda *a: fb.fused_attn_epilogue(*a, head_dim=D),
         lambda *a: fb._fused_attn_epilogue_plain(*a, D), epi_args),
        ("fused_mlp_fwd", lambda *a: fb.fused_mlp_fwd(*a, eps=eps),
         lambda *a: fb._fused_mlp_fwd_plain(*a, eps), mlp_args),
        ("fused_mlp_bwd_dx", lambda *a: fb.fused_mlp_bwd_dx(*a, eps=eps),
         lambda *a: fb._fused_mlp_bwd_dx_plain(*a, eps), dx_args),
    ]


def kernel_verify_cases():
    """(name, custom op, operand specs) for every kernel of the port that
    runs as a ``torch.library`` custom op: the operands as (shape, dtype)
    at representative shapes, the extra arguments after them.
    ``verify_case`` runs one under fake CUDA tensors: the op's own checks
    and output shapes, without a card or a launch (the counterpart of
    the reference's eval_shape sweep)."""
    bf, f32 = torch.bfloat16, torch.float32
    ops = torch.ops.paddle_tpu_torch
    B, S, H, D, I = 1, 256, 256, 128, 512
    x = ((B, S, H), bf)
    w = ((H, H), bf)
    rope = ((S, D), f32)
    heads = ((B, S, H // D, D), bf)
    return [
        ("flash_fwd", ops.flash_fwd, (heads, heads, heads), ()),
        ("fused_qkv", ops.fused_qkv,
         (x, ((H,), bf), w, w, w, rope, rope), (D, 1e-6)),
        ("fused_attn_epilogue", ops.fused_attn_epilogue,
         (x, x, x, x, w), (D,)),
        ("fused_mlp_fwd", ops.fused_mlp_fwd,
         (x, ((H,), bf), ((H, I), bf), ((H, I), bf), ((I, H), bf)),
         (1e-6,)),
    ]


def verify_case(case):
    """Run one ``kernel_verify_cases`` entry under fake CUDA tensors;
    returns its outputs' (shape, dtype) pairs, or raises what the op
    refuses."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _name, op, specs, extra = case
    with FakeTensorMode():
        args = [torch.empty(shape, dtype=dt, device="cuda")
                for shape, dt in specs]
        out = op(*args, *extra)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]
