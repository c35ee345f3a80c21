"""The op sweep's cases: one or more for every op of ``OP_LIBRARY``.

The counterpart of ``paddle_tpu/ops/codegen.parity_cases``, with the
input domains of the reference's generated op tests.  The module is
JAX-free and package-agnostic: a case names its op, makes its inputs
from a seed with numpy, and says which inputs are differentiable; a
runner takes a package's namespace (``paddle_tpu_torch``, or the
reference's) and returns numpy arrays.  The CPU tests hold the port
against the reference with it; ``chip_smoke.py``'s eager phase holds
the port's CUDA run against its CPU run.

- ``PARITY``: deterministic cases.  ``run(case, paddle, ops)`` gives the
  outputs and, for the ``grad`` inputs, the gradients of
  ``Σ_i sum(out_i * w_i)`` (``w_i`` fixed draws); ``compare`` holds two
  runs to the case's tolerance (f32 1e-5 elementwise, 1e-4 for
  reductions, linear algebra and every gradient; bf16 2e-2 relative
  and 2e-2 of the array's largest magnitude absolute).
  Integer and bool outputs must be equal.  Ties are in the inputs of the
  sorts, ``topk``, ``mode``, ``unique`` and the comparisons.
- ``LAWS``: the random ops, each checked against its law and for
  reproducibility (the same seed gives the same draws, a restored
  ``get_rng_state`` replays them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["Case", "Law", "PARITY", "LAWS", "BF16_OPS", "run", "compare",
           "covered_ops"]


class Case(NamedTuple):
    name: str                       # the OP_LIBRARY key
    args: tuple                     # input specs (see _mat)
    kwargs: Dict[str, Any]
    grad: Tuple[int, ...]           # differentiable positional inputs
    tol: float                      # forward tolerance (atol = rtol)
    gtol: float                     # gradient tolerance
    dtype: Optional[str]            # float inputs cast to it (bf16 cases)
    post: Optional[Callable]        # (paddle, outs) -> outs to compare
    tag: str

    @property
    def id(self):
        return f"{self.name}-{self.tag}" if self.tag else self.name


class Law(NamedTuple):
    name: str
    check: Callable                 # check(paddle) raises AssertionError
    tag: str = ""

    @property
    def id(self):
        return f"{self.name}-{self.tag}" if self.tag else self.name


# ---------------------------------------------------------------------------
# input specs: a callable(rng) is drawn, a list of them gives a list of
# tensors, numpy arrays become tensors, anything else passes as it is
# ---------------------------------------------------------------------------

def f(*shape, lo=0.1, hi=0.9):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def n(*shape, scale=1.0):
    return lambda rng: (rng.standard_normal(shape) * scale).astype(np.float32)


def i(*shape, lo=0, hi=5, dtype=np.int64):
    return lambda rng: rng.integers(lo, hi, shape).astype(dtype)


def b(*shape, p=0.5):
    return lambda rng: rng.uniform(0, 1, shape) < p


def fb(*shape, p=0.5):
    """0/1 float labels."""
    return lambda rng: (rng.uniform(0, 1, shape) < p).astype(np.float32)


def const(a):
    a = np.asarray(a)
    return lambda rng: a.copy()


def ties(*shape, levels=3):
    """Floats drawn from a few levels: sorts and comparisons see ties."""
    return lambda rng: rng.integers(0, levels, shape).astype(np.float32)


def spd(k, batch=()):
    def make(rng):
        a = rng.standard_normal(batch + (k, k)).astype(np.float32)
        return (a @ np.swapaxes(a, -1, -2) + k * np.eye(k, dtype=np.float32))
    return make


def well(k, batch=()):
    """A well-conditioned square matrix."""
    return lambda rng: (rng.standard_normal(batch + (k, k)) * 0.3
                        + np.eye(k) * 2).astype(np.float32)


def log_probs(*shape, axis=-1):
    def make(rng):
        z = rng.standard_normal(shape)
        z = z - z.max(axis, keepdims=True)
        return (z - np.log(np.exp(z).sum(axis, keepdims=True))
                ).astype(np.float32)
    return make


def probs(*shape):
    def make(rng):
        e = np.exp(rng.standard_normal(shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return make


def _mat(spec, rng):
    if callable(spec):
        return spec(rng)
    if isinstance(spec, list) and spec and callable(spec[0]):
        return [_mat(s, rng) for s in spec]
    return spec


PARITY: List[Case] = []


def case(name, *args, grad=(), tol=1e-5, gtol=1e-4, dtype=None, post=None,
         tag="", **kwargs):
    PARITY.append(Case(name, args, kwargs, tuple(grad), tol, gtol, dtype,
                       post, tag))


# the reference's generated-test domains
_DOMAINS = {
    "acosh": (1.1, 3.0), "cosh": (-2.0, 2.0), "sinh": (-2.0, 2.0),
    "exp": (-2.0, 2.0), "expm1": (-2.0, 2.0), "tan": (-1.2, 1.2),
    "sin": (-3.0, 3.0), "cos": (-3.0, 3.0), "tanh": (-3.0, 3.0),
    "atan": (-3.0, 3.0), "sign": (-2.0, 2.0), "sgn": (-2.0, 2.0),
    "abs": (-2.0, 2.0), "floor": (-2.0, 2.0), "ceil": (-2.0, 2.0),
    "round": (-2.0, 2.0), "trunc": (-2.0, 2.0), "square": (-2.0, 2.0),
    "frac": (-2.0, 2.0), "neg": (-2.0, 2.0), "asinh": (-2.0, 2.0),
    "deg2rad": (-3.0, 3.0), "rad2deg": (-3.0, 3.0), "erf": (-2.0, 2.0),
    "i0": (-2.0, 2.0),
}
_STEP = {"floor", "ceil", "round", "trunc", "sign", "sgn"}


def _away_from_steps(lo, hi):
    def make(rng):
        x = rng.uniform(lo, hi, (3, 4))
        frac = np.abs(x - np.round(x))
        x = np.where((frac < 0.05) | (np.abs(frac - 0.5) < 0.05), x + 0.1, x)
        return x.astype(np.float32)
    return make


for _u in ["abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil",
           "conj", "cos", "cosh", "deg2rad", "digamma", "erf", "erfinv",
           "exp", "expm1", "floor", "frac", "i0", "imag", "lgamma", "log",
           "log10", "log1p", "log2", "logit", "neg", "rad2deg", "real",
           "reciprocal", "round", "rsqrt", "sgn", "sign", "sin", "sinh",
           "sqrt", "square", "tan", "trunc", "sigmoid", "tanh"]:
    _lo, _hi = _DOMAINS.get(_u, (0.1, 0.9))
    case(_u, _away_from_steps(_lo, _hi) if _u in _STEP else f(3, 4, lo=_lo,
                                                            hi=_hi),
         grad=(0,))
_special = const(np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.5]],
                          np.float32))
for _u in ["isfinite", "isinf", "isnan"]:
    case(_u, _special)
case("nan_to_num", _special)
case("nan_to_num", _special, tag="values", nan=1.5, posinf=9.0, neginf=-9.0)
case("angle", n(3, 4), grad=(0,))
case("logical_not", b(3, 4))
case("bitwise_not", i(3, 4, lo=-8, hi=8))

for _b in ["add", "subtract", "multiply", "divide", "maximum", "minimum",
           "fmax", "fmin", "atan2", "hypot", "logaddexp", "kron"]:
    case(_b, f(3, 4), f(3, 4), grad=(0, 1))
case("add", f(3, 4), f(4), grad=(0, 1), tag="broadcast")
case("multiply", f(3, 4), f(3, 1), grad=(0, 1), tag="broadcast")
case("add", f(3, 4), 2.0, grad=(0,), tag="scalar")
case("multiply", f(3, 4), 3.0, grad=(0,), tag="scalar")
case("multiply", f(3, 4), 3.0, grad=(0,), tag="bf16-scalar",
     dtype="bfloat16", tol=2e-2, gtol=2e-2)
case("add", i(3, 4), f(3, 4), grad=(1,), tag="int-float")
case("divide", i(3, 4, lo=1, hi=9), i(3, 4, lo=1, hi=4), tag="int")
case("pow", f(3, 4), f(3, 4), grad=(0, 1))
case("pow", f(3, 4), 2.0, grad=(0,), tag="scalar")
case("copysign", n(3, 4), n(3, 4), grad=(0,))
case("heaviside", n(3, 4), f(3, 4))
case("nextafter", f(3, 4), f(3, 4))
case("floor_divide", n(3, 4, scale=3.0), f(3, 4, lo=0.5, hi=2.0))
case("floor_divide", i(3, 4, lo=-9, hi=9), i(3, 4, lo=1, hi=4), tag="int")
case("mod", n(3, 4, scale=3.0), f(3, 4, lo=0.5, hi=2.0), grad=(0,))
case("remainder", i(3, 4, lo=-9, hi=9), i(3, 4, lo=1, hi=4))
case("gcd", i(8, lo=0, hi=30), i(8, lo=1, hi=12))
case("lcm", i(8, lo=1, hi=12), i(8, lo=1, hi=12))
case("ldexp", f(3, 4), i(3, 4, lo=0, hi=4), grad=(0,))
case("inner", f(3, 4), f(2, 4), grad=(0, 1))
case("outer", f(3), f(4), grad=(0, 1))
for _c in ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"]:
    case(_c, ties(3, 4), ties(3, 4))
for _l in ["logical_and", "logical_or", "logical_xor"]:
    case(_l, b(3, 4), b(3, 4))
for _bw in ["bitwise_and", "bitwise_or", "bitwise_xor"]:
    case(_bw, i(3, 4, lo=0, hi=16), i(3, 4, lo=0, hi=16))
case("bitwise_left_shift", i(3, 4, lo=0, hi=16), i(3, 4, lo=0, hi=4))
case("bitwise_right_shift", i(3, 4, lo=0, hi=64), i(3, 4, lo=0, hi=4))

# -- reductions and scans ----------------------------------------------------
R = 1e-4
for _r in ["sum", "mean", "prod", "max", "min", "amax", "amin",
           "logsumexp"]:
    case(_r, f(3, 4, 5), grad=(0,), tol=R)
    case(_r, f(3, 4, 5), grad=(0,), tol=R, tag="axis", axis=1, keepdim=True)
    case(_r, f(3, 4, 5), grad=(0,), tol=R, tag="axes", axis=[0, 2])
case("sum", i(3, 4), tag="int", axis=0)
case("mean", i(3, 4), tag="int", axis=1)
case("nansum", f(3, 4), grad=(0,), tol=R, axis=1)
case("nanmean", f(3, 4), grad=(0,), tol=R, axis=1)
case("nansum", _special, tol=R, tag="nan")
case("nanmean", _special, tol=R, tag="nan", axis=1)
case("all", b(3, 4, p=0.8), axis=1)
case("any", b(3, 4, p=0.2), axis=0)
case("all", b(3, 4, p=0.9), tag="full")
case("std", f(3, 5), grad=(0,), tol=R, axis=1)
case("var", f(3, 5), grad=(0,), tol=R, axis=1, unbiased=False)
case("std", f(3, 5), grad=(0,), tol=R, tag="all")
case("median", f(3, 5), grad=(0,), tol=R, axis=1)
case("median", f(3, 4), grad=(0,), tol=R, tag="even")
case("quantile", f(3, 5), 0.3, grad=(0,), tol=R, axis=1)
case("quantile", f(3, 5), [0.25, 0.75], grad=(0,), tol=R, tag="qs",
     axis=0, keepdim=True)
case("count_nonzero", i(3, 4, lo=0, hi=3), axis=1)
case("cumsum", f(3, 4), grad=(0,), tol=R, axis=1)
case("cumsum", f(3, 4), grad=(0,), tol=R, tag="flat")
case("cumprod", f(3, 4), grad=(0,), tol=R, dim=1)
case("cummax", n(3, 6), grad=(0,), axis=1)
case("cummin", n(3, 6), grad=(0,), axis=1)
case("cummax", ties(3, 6), tag="ties", axis=1)
case("cummin", ties(3, 6), tag="ties", axis=0)
case("logcumsumexp", f(3, 4), grad=(0,), tol=R, axis=1)
case("add_n", [f(3, 4), f(3, 4), f(3, 4)], grad=(0,))
case("clip", n(3, 4), -0.5, 0.5, grad=(0,))
case("clip_by_norm", n(3, 4), 1.0, grad=(0,), tol=R)
case("renorm", n(3, 4), 2.0, 0, 1.0, grad=(0,), tol=R)
case("scale", n(3, 4), 2.0, 0.5, grad=(0,))
case("scale", n(3, 4), 2.0, 0.5, grad=(0,), tag="before",
     bias_after_scale=False, act="relu")
case("stanh", n(3, 4), grad=(0,))
case("increment", f(3), 2.0)
case("lerp", f(3, 4), f(3, 4), 0.3, grad=(0, 1))
case("multiplex", [f(3, 4), f(3, 4)], const(np.array([[1], [0], [1]],
                                                        np.int32)), grad=(0,))
case("trace", f(4, 4), grad=(0,), tol=R)
case("trace", f(3, 4, 5), grad=(0,), tol=R, tag="axes", offset=1, axis1=1,
     axis2=2)
case("diagonal", f(3, 4, 5), grad=(0,), offset=1, axis1=1, axis2=2)
case("diff", f(3, 5), grad=(0,), axis=1)
case("diff", f(3, 5), grad=(0,), tag="n2", n=2, axis=0,
     prepend=f(1, 5), append=f(2, 5))

# -- logic, attribute, einsum ------------------------------------------------
case("isclose", f(3, 4), const(np.full((3, 4), 0.5, np.float32)))
case("allclose", f(3, 4), f(3, 4))
case("equal_all", ties(3, 4, levels=1), ties(3, 4, levels=1))
case("is_empty", f(0, 3))
case("shape", f(3, 4, 5))
case("rank", f(3, 4, 5))
case("einsum", "ij,jk->ik", f(3, 4), f(4, 5), grad=(1, 2), tol=R)
case("einsum", "bij,bjk->bik", f(2, 3, 4), f(2, 4, 5), grad=(1, 2), tol=R,
     tag="batched")

# -- creation ----------------------------------------------------------------
case("zeros", [2, 3])
case("ones", [2, 3], "int32")
case("full", [2, 3], 7.5)
case("full", [2, 3], 7, tag="int")
case("empty", [2, 3])
case("eye", 3, 4)
case("arange", 0, 7, 2)
case("arange", 1.0, 3.0, 0.5, tag="float")
case("linspace", 0.0, 1.0, 7)
case("logspace", 0.0, 2.0, 5)
case("zeros_like", f(2, 3))
case("ones_like", f(2, 3))
case("full_like", f(2, 3), 2.5)
case("empty_like", f(2, 3))
case("tril", f(4, 4), grad=(0,))
case("triu", f(4, 5), 1, grad=(0,))
case("tril_indices", 4, 5, 1)
case("triu_indices", 4)
case("meshgrid", f(3), f(4), grad=(0, 1))
case("diag", f(4), grad=(0,))
case("diag", f(3), 1, 9.0, grad=(0,), tag="pad")
case("diag", f(3, 4), -1, grad=(0,), tag="2d")
case("diagflat", f(2, 2), 1, grad=(0,))
case("diag_embed", f(2, 3), grad=(0,))
case("assign", f(3, 4), grad=(0,))
case("clone", f(3, 4), grad=(0,))
case("complex", f(3), f(3))

# -- manipulation -------------------------------------------------------------
case("reshape", f(2, 6), [3, -1], grad=(0,))
case("reshape", f(2, 3, 2), [0, 6], grad=(0,), tag="zero")
case("flatten", f(2, 3, 4), 1, 2, grad=(0,))
case("squeeze", f(2, 1, 3, 1), grad=(0,))
case("squeeze", f(2, 1, 3, 1), 1, grad=(0,), tag="axis")
case("unsqueeze", f(2, 3), [0, 2], grad=(0,))
case("transpose", f(2, 3, 4), [2, 0, 1], grad=(0,))
case("moveaxis", f(2, 3, 4), 0, 2, grad=(0,))
case("swapaxes", f(2, 3, 4), 0, 2, grad=(0,))
case("concat", [f(2, 3), f(4, 3)], grad=(0,))
case("concat", [f(2, 3), f(2, 1)], 1, grad=(0,), tag="axis1")
case("stack", [f(2, 3), f(2, 3)], 1, grad=(0,))
case("split", f(6, 4), 3, grad=(0,))
case("split", f(6, 4), [1, -1, 2], 0, grad=(0,), tag="sections")
case("chunk", f(4, 6), 2, 1, grad=(0,))
case("unstack", f(3, 4), 1, grad=(0,))
case("unbind", f(3, 4), grad=(0,))
case("tile", f(2, 3), [2, 1, 2], grad=(0,))
case("expand", f(3, 1), [2, 3, 4], grad=(0,))
case("expand", f(3, 1), [-1, 4], grad=(0,), tag="keep")
case("expand_as", f(1, 4), f(3, 4), grad=(0,))
case("broadcast_to", f(1, 4), [3, 4], grad=(0,))
case("broadcast_tensors", [f(3, 1), f(1, 4)], grad=(0,))
case("flip", f(3, 4), [0, 1], grad=(0,))
case("rot90", f(3, 4), 1, grad=(0,))
case("rot90", f(3, 4), -3, [1, 0], grad=(0,), tag="axes")
case("roll", f(3, 4), 1, grad=(0,))
case("roll", f(3, 4), [1, -2], [0, 1], grad=(0,), tag="axes")
case("gather", f(5, 3), i(4, hi=5), grad=(0,))
case("gather", f(3, 5), i(4, hi=5), 1, grad=(0,), tag="axis1")
case("gather_nd", f(3, 4, 2), const(np.array([[0, 1], [2, 3], [1, 1]])),
     grad=(0,))
case("scatter", f(5, 3), const(np.array([3, 0, 1])), f(3, 3), grad=(0, 2))
case("scatter", f(5, 3), const(np.array([3, 0, 3])), f(3, 3), grad=(2,),
     tag="add", overwrite=False)
case("scatter_", f(5, 3), const(np.array([3, 0, 1])), f(3, 3))
case("scatter_nd", const(np.array([[1], [3], [1]])), f(3, 4), [5, 4],
     grad=(1,))
case("scatter_nd_add", f(5, 4), const(np.array([[1], [3], [1]])), f(3, 4),
     grad=(0, 2))
case("index_select", f(5, 3), i(4, hi=5), grad=(0,))
case("index_select", f(3, 5), i(4, hi=5), 1, grad=(0,), tag="axis1")
case("index_sample", f(3, 5), i(3, 4, hi=5), grad=(0,))
case("index_add", f(5, 3), const(np.array([0, 2, 2])), 0, f(3, 3),
     grad=(0, 3))
case("index_put", f(4, 3), [const(np.array([0, 2])), const(np.array([1, 1]))],
     f(2), grad=(0, 2))
case("index_put", f(4, 3), [const(np.array([0, 0]))], f(2, 3), grad=(0,),
     tag="acc", accumulate=True)
case("masked_select", f(3, 4), b(3, 4))
case("masked_fill", f(3, 4), b(3, 4), 9.0, grad=(0,))
case("where", b(3, 4), f(3, 4), f(3, 4), grad=(1, 2))
case("where", b(3, 1), f(1, 4), 0.5, grad=(1,), tag="broadcast")
case("take_along_axis", f(3, 5), i(3, 2, hi=5), 1, grad=(0,))
case("put_along_axis", f(3, 5), const(np.array([[0, 3], [1, 2], [4, 0]])),
     f(3, 2), 1, grad=(0, 2))
case("put_along_axis", f(3, 5), const(np.array([[0], [1], [4]])), f(3, 1),
     1, grad=(0,), tag="add", reduce="add")
case("put_along_axis", f(3, 5), const(np.array([[0], [1], [4]])), f(3, 1),
     1, tag="mul", reduce="mul")
case("cast", f(3, 4, lo=-3, hi=3), "int32")
case("cast", f(3, 4), "float64", grad=(0,), tag="f64")
case("slice", f(4, 5), [0, 1], [1, -3], [3, 10], grad=(0,))
case("crop", f(4, 5), [2, 3], [1, 1], grad=(0,))
case("crop", f(4, 5), [2, -1], [3, 1], grad=(0,), tag="clamped")
case("pad", f(3, 4), [1, 0, 2, 1], grad=(0,))
case("pad", f(1, 2, 4, 5), [1, 2, 2, 1], grad=(0,), tag="nchw",
     value=3.0)
for _m in ["reflect", "replicate", "circular"]:
    case("pad", f(1, 2, 4, 5), [1, 2, 2, 1], grad=(0,), tag=_m, mode=_m)
case("pad", f(1, 4, 5, 2), [1, 2, 2, 1], grad=(0,), tag="nhwc",
     mode="reflect", data_format="NHWC")
case("repeat_interleave", f(3, 2), 2, 0, grad=(0,))
case("repeat_interleave", f(3, 2), 2, grad=(0,), tag="flat")
case("repeat_interleave", f(3, 2), const(np.array([1, 0, 2])), 0,
     tag="tensor")
case("as_complex", f(3, 2))
case("as_real", lambda rng: (rng.standard_normal(3)
                             + 1j * rng.standard_normal(3)).astype(
                                 np.complex64))
case("atleast_1d", const(np.float32(2.5)))
case("atleast_2d", f(3), grad=(0,))
case("atleast_3d", f(2, 3), grad=(0,))
case("tensordot", f(2, 3, 4), f(3, 4, 5), 2, grad=(0, 1), tol=R)
case("tensordot", f(2, 3, 4), f(4, 2), [[0, 2], [1, 0]], grad=(0, 1),
     tol=R, tag="pairs")
case("numel", f(3, 4))
case("shard_index", i(6, 1, lo=0, hi=20), 20, 2, 1)
case("fill_diagonal_", f(4, 4), 5.0)
case("fill_diagonal_", f(3, 5), 2.0, 1, tag="offset")

# -- search ------------------------------------------------------------------
case("argmax", ties(3, 5), tag="ties")
case("argmax", f(3, 5), 1, tag="axis")
case("argmin", ties(3, 5), 1, True, tag="ties")
case("argsort", ties(3, 6), tag="ties")
case("argsort", ties(3, 6), 1, True, tag="desc")
case("sort", ties(3, 6), grad=(0,), tag="ties")
case("sort", f(3, 6), 0, True, grad=(0,), tag="desc")
case("topk", f(3, 6), 2, grad=(0,))
case("topk", ties(3, 6), 3, tag="ties")
case("topk", ties(3, 6), 2, 0, False, tag="smallest")
case("kthvalue", f(3, 6), 2, grad=(0,))
case("kthvalue", ties(3, 6), 3, 1, True, tag="ties")
case("mode", ties(3, 7))
case("mode", ties(4, 3), 0, True, tag="axis0")
case("nonzero", b(3, 4))
case("nonzero", b(3, 4), True, tag="tuple")
case("searchsorted", const(np.array([0.1, 0.3, 0.3, 0.7], np.float32)),
     f(2, 3))
case("searchsorted", lambda rng: np.sort(rng.uniform(0, 1, (2, 5)),
                                         -1).astype(np.float32),
     f(2, 3), True, True, tag="right2d")
case("bucketize", f(5), const(np.array([0.2, 0.5, 0.8], np.float32)))
case("unique", ties(12, levels=5), True, True, True, tag="all")
case("unique", ties(3, 4, levels=4))
case("unique_consecutive", ties(12, levels=3), True, True)
case("histogram", f(20), 5, 0.0, 1.0)
case("histogram", ties(20, levels=4), 4, tag="range")
case("bincount", i(10, lo=0, hi=6))
case("bincount", i(10, lo=0, hi=4), f(10), 6, tag="weights", tol=R)

# -- linear algebra ------------------------------------------------------------
case("matmul", f(3, 4), f(4, 5), grad=(0, 1), tol=R)
case("matmul", f(2, 4, 3), f(2, 5, 4), grad=(0, 1), tol=R, tag="trans",
     transpose_x=True, transpose_y=True)
case("matmul", f(3, 4), f(4), grad=(0, 1), tol=R, tag="vec")
case("bmm", f(2, 3, 4), f(2, 4, 5), grad=(0, 1), tol=R)
case("dot", f(4), f(4), grad=(0, 1), tol=R)
case("mv", f(3, 4), f(4), grad=(0, 1), tol=R)
case("t", f(3, 4), grad=(0,))
case("matrix_transpose", f(2, 3, 4), grad=(0,))
case("norm", n(3, 4), grad=(0,), tol=R)
case("norm", n(3, 4), 1, 1, grad=(0,), tol=R, tag="l1")
case("norm", n(3, 4), float("inf"), 0, grad=(0,), tol=R, tag="inf")
case("norm", n(3, 4), "fro", [0, 1], grad=(0,), tol=R, tag="fro")
case("norm", n(3, 4), 3, 1, True, grad=(0,), tol=R, tag="p3")
case("dist", f(3, 4), f(3, 4), grad=(0, 1), tol=R)
case("dist", f(3, 4), f(3, 4), float("inf"), tol=R, tag="inf")
case("cross", f(2, 3), f(2, 3), grad=(0, 1), tol=R)
case("cholesky", spd(3), grad=(0,), tol=R)
case("cholesky", spd(3, (2,)), True, grad=(0,), tol=R, tag="upper")
case("cholesky_solve", f(3, 2), lambda rng: np.linalg.cholesky(
    spd(3)(rng)).astype(np.float32), grad=(0, 1), tol=R)
case("inv", well(3), grad=(0,), tol=R)
case("det", well(3), grad=(0,), tol=R)
case("slogdet", well(3), grad=(0,), tol=R)
case("solve", well(3), f(3, 2), grad=(0, 1), tol=R)
case("solve", well(3), f(3), grad=(0, 1), tol=R, tag="vec")
case("triangular_solve", lambda rng: np.triu(well(3)(rng)), f(3, 2),
     grad=(1,), tol=R)
case("triangular_solve", lambda rng: np.tril(well(3)(rng)), f(3, 2),
     False, True, grad=(1,), tol=R, tag="lower-t")
case("matrix_power", well(3), 3, grad=(0,), tol=R)
case("matrix_power", well(3), -1, tol=R, tag="inv")
case("matrix_rank", lambda rng: np.outer(rng.uniform(0.1, 1, 4),
                                         rng.uniform(0.1, 1, 3)
                                         ).astype(np.float32))
case("multi_dot", [f(2, 3), f(3, 4), f(4, 2)], grad=(0,), tol=R)
case("corrcoef", f(3, 6), grad=(0,), tol=R)
case("cov", f(3, 6), grad=(0,), tol=R)
case("cov", f(6, 3), False, False, grad=(0,), tol=R, tag="cols")
case("householder_product", f(4, 3), f(3), grad=(0, 1), tol=R)
case("pinv", f(4, 3), grad=(0,), tol=R)
case("lstsq", f(5, 3), f(5, 2), grad=(0, 1), tol=R)
case("lu", well(3))
case("cond", well(3), tol=R)


def _abs_all(paddle, outs):
    """Decompositions' signs are a convention: compare magnitudes."""
    return [paddle.abs(o) for o in outs]


def _eigh_post(paddle, outs):
    return [outs[0], paddle.abs(outs[1])]


def _sorted_real(paddle, outs):
    return [paddle.sort(paddle.real(outs[0]))]


case("qr", f(4, 3), grad=(0,), tol=R, post=_abs_all)
case("svd", f(4, 3), grad=(0,), tol=R, post=_abs_all)
case("eigh", spd(3), grad=(0,), tol=R, post=_eigh_post)
case("eigvalsh", spd(3), grad=(0,), tol=R)
case("eig", spd(3), tol=R, post=_sorted_real)
case("eigvals", spd(3), tol=R, post=_sorted_real)

# -- nn.functional: activations ------------------------------------------------
for _a in ["relu", "relu6", "leaky_relu", "elu", "selu", "celu", "gelu",
           "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "softplus", "softsign",
           "log_sigmoid", "thresholded_relu"]:
    case(_a, n(3, 4, scale=2.0), grad=(0,))
case("gelu", n(3, 4), True, grad=(0,), tag="tanh")
case("leaky_relu", n(3, 4), 0.2, grad=(0,), tag="slope")
case("softmax", n(3, 4), grad=(0,))
case("softmax", n(3, 4, 2), 1, grad=(0,), tag="axis1")
case("log_softmax", n(3, 4), grad=(0,))
case("prelu", n(2, 3, 4), f(3), grad=(0, 1))
case("prelu", n(2, 3), f(1), grad=(0, 1), tag="shared")
case("maxout", n(2, 4, 3), 2, grad=(0,))
case("glu", n(3, 4), grad=(0,))
case("rrelu", n(3, 4), training=False, grad=(0,), tag="eval")

# -- nn.functional: common -------------------------------------------------------
case("linear", f(2, 3), f(3, 4), f(4), grad=(0, 1, 2), tol=R)
case("linear", f(2, 3), f(3, 4), grad=(0, 1), tol=R, tag="nobias")
case("bilinear", f(2, 3), f(2, 4), f(5, 3, 4), f(5), grad=(0, 1, 2, 3),
     tol=R)
case("embedding", i(2, 3, hi=5), f(5, 4), grad=(1,))
case("embedding", i(2, 3, hi=5), f(5, 4), 1, grad=(1,), tag="pad")
case("one_hot", i(2, 3, hi=5), 5)
case("label_smooth", probs(2, 5), grad=(0,))
case("label_smooth", probs(2, 5), probs(5), 0.2, grad=(0, 1), tag="prior")
case("cosine_similarity", f(3, 4), f(3, 4), grad=(0, 1), tol=R)
case("pairwise_distance", f(3, 4), f(3, 4), grad=(0, 1), tol=R)
case("pixel_shuffle", f(1, 8, 2, 3), 2, grad=(0,))
case("pixel_shuffle", f(1, 2, 3, 8), 2, "NHWC", grad=(0,), tag="nhwc")
case("pixel_unshuffle", f(1, 2, 4, 6), 2, grad=(0,))
case("channel_shuffle", f(2, 4, 3, 3), 2, grad=(0,))
case("interpolate", f(2, 3, 4, 5), [6, 7], grad=(0,))
case("interpolate", f(2, 3, 4, 5), None, 2.0, "bilinear", grad=(0,),
     tol=R, tag="bilinear")
case("interpolate", f(1, 2, 8, 9), [3, 4], None, "bilinear", grad=(0,),
     tol=R, tag="shrink")
case("interpolate", f(1, 2, 4, 5), [7, 9], None, "bicubic", grad=(0,),
     tol=R, tag="bicubic")
case("interpolate", f(1, 5, 6, 2), [9, 4], None, "bilinear", grad=(0,),
     tol=R, tag="nhwc", data_format="NHWC")
case("upsample", f(1, 2, 5), [9], None, "linear", grad=(0,), tol=R,
     data_format="NCW")
case("unfold", f(1, 2, 5, 5), 3, grad=(0,))
case("unfold", f(1, 2, 6, 5), [2, 3], 2, [1, 0, 2, 1], 1, grad=(0,),
     tag="padded")
case("fold", f(1, 8, 9), [4, 4], 2, grad=(0,))
case("zeropad2d", f(1, 2, 3, 3), [1, 0, 2, 1], grad=(0,))
case("dropout", f(3, 4), 0.3, training=False, grad=(0,), tag="eval")
case("dropout", f(3, 4), 0.3, training=False, mode="downscale_in_infer",
     grad=(0,), tag="downscale")
case("dropout2d", f(2, 3, 4, 4), 0.5, False, grad=(0,), tag="eval")
case("dropout3d", f(2, 3, 2, 2, 2), 0.5, False, grad=(0,), tag="eval")
case("alpha_dropout", f(3, 4), 0.5, False, grad=(0,), tag="eval")
case("scaled_dot_product_attention", n(2, 5, 2, 8), n(2, 5, 2, 8),
     n(2, 5, 2, 8), grad=(0, 1, 2), tol=R, is_causal=True)
case("scaled_dot_product_attention", n(2, 4, 2, 8), n(2, 6, 2, 8),
     n(2, 6, 2, 8), b(2, 2, 4, 6, p=0.8), grad=(0, 1, 2), tol=R, tag="mask")

# -- nn.functional: norms --------------------------------------------------------
case("layer_norm", n(2, 3, 6), 6, f(6), f(6), grad=(0, 1, 2), tol=R)
case("layer_norm", n(2, 3, 6), [3, 6], grad=(0,), tol=R, tag="2d")
case("rms_norm", n(2, 3, 8), f(8), grad=(0, 1), tol=R)
case("rms_norm", n(2, 3, 8), grad=(0,), tol=R, tag="noweight",
     epsilon=1e-5)
case("batch_norm", n(4, 3, 2, 2), f(3), f(3, lo=0.5, hi=1.5), f(3), f(3),
     grad=(0, 3, 4), tol=R)
case("batch_norm", n(4, 3, 2, 2), f(3), f(3, lo=0.5, hi=1.5), f(3), f(3),
     grad=(0, 3, 4), tol=R, tag="train", training=True)
case("batch_norm", n(4, 5, 3), f(3), f(3, lo=0.5, hi=1.5), grad=(0,),
     tol=R, tag="nlc", training=True, data_format="NLC")
case("instance_norm", n(2, 3, 4, 4), weight=f(3), bias=f(3), grad=(0,),
     tol=R)
case("group_norm", n(2, 4, 3, 3), 2, 1e-5, f(4), f(4), grad=(0, 3, 4),
     tol=R)
case("group_norm", n(2, 3, 3, 4), 2, tag="nhwc", grad=(0,), tol=R,
     data_format="NHWC")
case("local_response_norm", n(2, 5, 3, 3), 3, grad=(0,), tol=R)
case("normalize", n(3, 4), grad=(0,), tol=R)
case("normalize", n(3, 4), 1, 0, grad=(0,), tol=R, tag="l1")

# -- nn.functional: losses -------------------------------------------------------
_lab = i(6, hi=5)
case("cross_entropy", n(6, 5), _lab, grad=(0,), tol=R)
case("cross_entropy", n(6, 5), const(np.array([0, -100, 3, 4, -100, 1])),
     grad=(0,), tol=R, tag="ignore")
case("cross_entropy", n(6, 5), const(np.full(6, -100)), grad=(0,), tol=R,
     tag="all-ignored")
case("cross_entropy", n(6, 5), const(np.array([0, -100, 3, 4, -100, 1])),
     grad=(0,), tol=R, tag="weight", weight=f(5))
case("cross_entropy", n(6, 5), i(6, 1, hi=5), grad=(0,), tol=R,
     tag="n1-label", reduction="sum")
case("cross_entropy", n(6, 5), lambda rng: rng.integers(0, 5, 6).astype(
    np.float32), grad=(0,), tol=R, tag="float-label", reduction="none")
case("cross_entropy", n(6, 5), probs(6, 5), grad=(0, 1), tol=R, tag="soft",
     soft_label=True)
case("cross_entropy", n(6, 5), probs(6, 5), grad=(0,), tol=R,
     tag="soft-weight", soft_label=True, weight=f(5), label_smoothing=0.1)
case("cross_entropy", n(6, 5), _lab, grad=(0,), tol=R, tag="smooth",
     label_smoothing=0.1)
case("cross_entropy", n(2, 5, 3), i(2, 3, hi=5), grad=(0,), tol=R,
     tag="axis1", axis=1)
case("cross_entropy", probs(6, 5), _lab, grad=(0,), tol=R, tag="probs",
     use_softmax=False)
case("softmax_with_cross_entropy", n(6, 5), i(6, 1, hi=5), grad=(0,),
     tol=R)
case("softmax_with_cross_entropy", n(6, 5), i(6, 1, hi=5), grad=(0,),
     tol=R, tag="softmax", return_softmax=True)
case("softmax_cross_entropy_with_logits", n(6, 5), probs(6, 5), grad=(0,),
     tol=R)
case("binary_cross_entropy", f(3, 4), fb(3, 4), grad=(0,), tol=R)
case("binary_cross_entropy", f(3, 4), f(3, 4), f(3, 4), grad=(0,), tol=R,
     tag="weight", reduction="none")
case("binary_cross_entropy_with_logits", n(3, 4), f(3, 4), grad=(0,), tol=R)
case("binary_cross_entropy_with_logits", n(3, 4), f(3, 4), f(3, 4), "sum",
     f(4), grad=(0,), tol=R, tag="pos-weight")
case("mse_loss", n(3, 4), n(3, 4), grad=(0, 1), tol=R)
case("square_error_cost", n(3, 4), n(3, 4), grad=(0, 1))
case("l1_loss", n(3, 4), n(3, 4), "sum", grad=(0,), tol=R)
case("nll_loss", log_probs(6, 5), const(np.array([0, -100, 3, 4, 2, 1])),
     grad=(0,), tol=R)
case("nll_loss", log_probs(6, 5), _lab, f(5), grad=(0,), tol=R,
     tag="weight")
case("nll_loss", log_probs(6, 5), _lab, grad=(0,), tol=R, tag="none",
     reduction="none")
case("smooth_l1_loss", n(3, 4), n(3, 4), grad=(0,), tol=R)
case("kl_div", log_probs(3, 4), probs(3, 4), grad=(0,), tol=R)
case("margin_ranking_loss", n(5), n(5), const(np.array(
    [1, -1, 1, 1, -1], np.float32)), 0.1, grad=(0, 1), tol=R)
case("cosine_embedding_loss", n(4, 3), n(4, 3), const(np.array(
    [1, -1, 1, -1], np.float32)), 0.1, grad=(0, 1), tol=R)
case("hinge_embedding_loss", n(4, 3), const(np.array(
    [[1, -1, 1]] * 4, np.float32)), grad=(0,), tol=R)
case("triplet_margin_loss", n(4, 3), n(4, 3), n(4, 3), grad=(0, 1, 2),
     tol=R)
case("triplet_margin_loss", n(4, 3), n(4, 3), n(4, 3), 0.5, 1, 1e-6, True,
     grad=(0, 1, 2), tol=R, tag="swap")
case("triplet_margin_with_distance_loss", n(4, 3), n(4, 3), n(4, 3),
     grad=(0, 1, 2), tol=R)
case("ctc_loss", log_probs(6, 2, 4), const(np.array([[1, 2], [3, 3]])),
     const(np.array([6, 5])), const(np.array([2, 2])), grad=(0,), tol=R)
case("ctc_loss", log_probs(6, 2, 4), const(np.array([[1, 2], [3, 1]])),
     const(np.array([6, 6])), const(np.array([2, 1])), grad=(0,), tol=R,
     tag="sum", reduction="sum")
case("sigmoid_focal_loss", n(3, 4), fb(3, 4), grad=(0,), tol=R)
case("sigmoid_focal_loss", n(3, 4), fb(3, 4), const(np.float32(4.0)),
     grad=(0,), tol=R, tag="norm", reduction="mean")
case("log_loss", f(4, 1), fb(4, 1), grad=(0,), tol=R)
case("npair_loss", n(4, 3), n(4, 3), const(np.array([1, 2, 1, 3])),
     grad=(0, 1), tol=R)
case("multi_label_soft_margin_loss", n(3, 4), fb(3, 4), grad=(0,), tol=R)
case("multi_label_soft_margin_loss", n(3, 4), fb(3, 4), f(4), grad=(0,),
     tol=R, tag="weight")
case("soft_margin_loss", n(3, 4), const(np.where(
    np.arange(12).reshape(3, 4) % 3, 1.0, -1.0).astype(np.float32)),
     grad=(0,), tol=R)
case("poisson_nll_loss", n(3, 4), f(3, 4, lo=0, hi=3), grad=(0,), tol=R)
case("poisson_nll_loss", f(3, 4, lo=0.5, hi=2), f(3, 4, lo=0, hi=3), False,
     True, grad=(0,), tol=R, tag="full")
case("rnnt_loss", n(2, 4, 3, 5), const(np.array([[1, 2], [3, 4]])),
     const(np.array([4, 3])), const(np.array([2, 1])), grad=(0,), tol=R)
case("rnnt_loss", n(2, 4, 3, 5), const(np.array([[1, 2], [3, 4]])),
     const(np.array([4, 4])), const(np.array([2, 2])), grad=(0,), tol=R,
     tag="plain", fastemit_lambda=0.0, reduction="none")
case("hsigmoid_loss", n(4, 3), const(np.array([0, 4, 2, 3])), 5, n(4, 3),
     n(4), grad=(0, 3, 4), tol=R)
case("dice_loss", probs(2, 3, 4), i(2, 3, 1, hi=4), grad=(0,), tol=R)
case("multi_margin_loss", n(4, 5), const(np.array([0, 4, 2, 3])),
     grad=(0,), tol=R)
case("multi_margin_loss", n(4, 5), const(np.array([0, 4, 2, 3])), 2, 0.5,
     f(5), grad=(0,), tol=R, tag="weighted")

# the ops the models run, in bf16 (the card's dtype for them)
BF16_OPS = ("matmul", "softmax", "cross_entropy", "layer_norm", "rms_norm",
            "gelu", "silu", "sum", "mean", "max")
_B = dict(dtype="bfloat16", tol=2e-2, gtol=2e-2, tag="bf16")
case("matmul", n(8, 32), n(32, 16), grad=(0, 1), **_B)
case("softmax", n(4, 64, scale=2.0), grad=(0,), **_B)
case("cross_entropy", n(16, 64, scale=2.0), i(16, hi=64), grad=(0,), **_B)
case("layer_norm", n(4, 64), 64, f(64), f(64), grad=(0, 1, 2), **_B)
case("rms_norm", n(4, 64), f(64), grad=(0, 1), **_B)
case("gelu", n(4, 64), grad=(0,), **_B)
case("silu", n(4, 64), grad=(0,), **_B)
case("sum", n(4, 64), -1, grad=(0,), **_B)
case("mean", n(4, 64), -1, grad=(0,), **_B)
case("max", n(4, 64), -1, grad=(0,), **_B)


# -- the vision stack: conv, pooling, vision, extended, geometric, ops -----


def boxes(n, size=8.0):
    """``n`` boxes (x1, y1, x2, y2) inside [0, size]."""
    def make(rng):
        xy = rng.uniform(0, size * 0.55, (n, 2))
        wh = rng.uniform(1.0, size * 0.45, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return make


def unpool_idx(lead, outs, k):
    """Flat indices a non-overlapping k-pool (stride k) could have
    recorded for an output of spatial size ``outs``: one position in
    each window, over the input's k-times-larger plane (volume)."""
    def make(rng):
        grids = np.meshgrid(*[np.arange(o) for o in outs], indexing="ij")
        flat = np.zeros(tuple(lead) + tuple(outs), np.int64)
        for g, o in zip(grids, outs):
            pos = g * k + rng.integers(0, k, tuple(lead) + tuple(outs))
            flat = flat * (o * k) + pos
        return flat.astype(np.int32)
    return make


def _unpool_after(nd):
    """``post``: unpool the (values, mask) of a return_mask pool."""
    def post(paddle, outs):
        fn = getattr(paddle.nn.functional, f"max_unpool{nd}d")
        return [fn(outs[0], outs[1], 2)]
    return post


_CV = dict(tol=R, gtol=R)
# conv: padding forms, "SAME" at stride 2 (an asymmetric split), groups,
# dilation, channels-last; the transposed conv (the reference's
# unflipped lhs-dilation form) at strides 1 and 2
case("conv1d", n(2, 3, 8), n(4, 3, 3), n(4), grad=(0, 1, 2), padding=1,
     **_CV)
case("conv1d", n(2, 8, 3), n(4, 3, 3), grad=(0, 1), tag="nlc-same-s2",
     stride=2, padding="SAME", data_format="NLC", **_CV)
case("conv2d", n(2, 3, 6, 6), n(4, 3, 3, 3), n(4), grad=(0, 1, 2),
     padding=1, **_CV)
case("conv2d", n(2, 3, 6, 6), n(4, 3, 3, 3), grad=(0, 1), tag="same-s2",
     stride=2, padding="SAME", **_CV)
case("conv2d", n(2, 4, 7, 7), n(4, 2, 3, 3), n(4), grad=(0, 1, 2),
     tag="groups-dilation", groups=2, dilation=2, padding=[1, 2], **_CV)
case("conv2d", n(2, 6, 5, 3), n(4, 3, 2, 2), grad=(0, 1), tag="nhwc-pairs",
     padding=[1, 0, 0, 1], data_format="NHWC", **_CV)
case("conv2d", n(1, 2, 5, 5), n(3, 2, 3, 3), grad=(0, 1), tag="valid-s2",
     stride=2, padding="VALID", **_CV)
case("conv3d", n(1, 2, 4, 4, 4), n(3, 2, 2, 2, 2), n(3), grad=(0, 1, 2),
     padding=1, **_CV)
case("conv1d_transpose", n(2, 3, 5), n(3, 2, 3), n(2), grad=(0, 1, 2),
     stride=2, padding=1, output_padding=1, **_CV)
case("conv2d_transpose", n(2, 3, 4, 4), n(3, 2, 3, 3), n(2),
     grad=(0, 1, 2), tag="s1", **_CV)
case("conv2d_transpose", n(2, 3, 4, 4), n(3, 2, 3, 3), grad=(0, 1),
     tag="s2-p1", stride=2, padding=1, **_CV)
case("conv2d_transpose", n(1, 2, 3, 3), n(2, 2, 3, 3), grad=(0, 1),
     tag="s2-outpad-dil", stride=2, padding=1, output_padding=1,
     dilation=2, **_CV)
case("conv2d_transpose", n(1, 4, 4, 2), n(2, 3, 3, 3), grad=(0, 1),
     tag="nhwc-p2", padding=2, data_format="NHWC", **_CV)
case("conv3d_transpose", n(1, 2, 3, 3, 3), n(2, 2, 2, 2, 2), n(2),
     grad=(0, 1, 2), stride=2, **_CV)

# pooling: the reference's windows and divisors (ceil_mode widens the
# high side; once widened, or exclusive with padding, the divisor is the
# count of real elements); tied inputs; return_mask into max_unpool
case("avg_pool1d", n(2, 3, 7), 3, 2, 1, grad=(0,), **_CV)
case("avg_pool1d", n(2, 3, 8), 3, 2, grad=(0,), tag="ceil", ceil_mode=True,
     **_CV)
case("avg_pool2d", n(2, 3, 6, 6), 3, 2, 1, grad=(0,), **_CV)
case("avg_pool2d", n(2, 3, 6, 6), 3, 2, 1, grad=(0,), tag="inclusive",
     exclusive=False, **_CV)
case("avg_pool2d", n(2, 3, 7, 6), 2, 2, grad=(0,), tag="ceil",
     ceil_mode=True, **_CV)
case("avg_pool2d", n(2, 3, 7, 6), 3, 2, 1, grad=(0,),
     tag="ceil-inclusive", ceil_mode=True, exclusive=False, **_CV)
case("avg_pool2d", n(2, 3, 7, 6), 3, 2, 1, grad=(0,), tag="ceil-exclusive",
     ceil_mode=True, exclusive=True, **_CV)
case("avg_pool2d", n(2, 5, 5, 3), 2, 1, [0, 1, 1, 0], grad=(0,),
     tag="nhwc-pairs", exclusive=True, data_format="NHWC", **_CV)
case("avg_pool2d", n(1, 2, 6, 6), 3, 2, "SAME", grad=(0,), tag="same",
     **_CV)
case("avg_pool3d", n(1, 2, 5, 5, 5), 2, 2, 1, grad=(0,), ceil_mode=True,
     **_CV)
case("max_pool1d", n(2, 3, 7), 3, 2, 1, grad=(0,), **_CV)
case("max_pool1d", n(2, 3, 8), 2, grad=(0,), tag="mask-unpool",
     return_mask=True, post=_unpool_after(1), **_CV)
case("max_pool2d", n(2, 3, 7, 7), 3, 2, 1, grad=(0,), **_CV)
case("max_pool2d", n(2, 3, 7, 6), 3, 2, 1, grad=(0,), tag="ceil",
     ceil_mode=True, **_CV)
case("max_pool2d", ties(2, 3, 6, 6, levels=2), 2, 2, grad=(0,),
     tag="ties", **_CV)
case("max_pool2d", n(2, 3, 5, 4), 3, 2, 1, grad=(0,), tag="nhwc",
     data_format="NHWC", **_CV)
case("max_pool2d", n(2, 3, 6, 6), 2, grad=(0,), tag="mask",
     return_mask=True, **_CV)
case("max_pool2d", n(2, 3, 6, 6), 2, grad=(0,), tag="mask-unpool",
     return_mask=True, post=_unpool_after(2), **_CV)
case("max_pool2d", ties(2, 3, 6, 6, levels=2), 2, grad=(0,),
     tag="mask-ties", return_mask=True, **_CV)
case("max_pool3d", n(1, 2, 5, 5, 5), 3, 2, 1, grad=(0,), **_CV)
case("max_pool3d", n(1, 2, 4, 4, 4), 2, grad=(0,), tag="mask-unpool",
     return_mask=True, post=_unpool_after(3), **_CV)
case("max_unpool1d", n(2, 3, 4), unpool_idx((2, 3), (4,), 2), 2,
     grad=(0,), **_CV)
case("max_unpool2d", n(2, 3, 3, 2), unpool_idx((2, 3), (3, 2), 2), 2,
     grad=(0,), **_CV)
case("max_unpool3d", n(1, 2, 2, 2, 2), unpool_idx((1, 2), (2, 2, 2), 2), 2,
     grad=(0,), **_CV)
case("adaptive_avg_pool1d", n(2, 3, 8), 3, grad=(0,), **_CV)
case("adaptive_avg_pool2d", n(2, 3, 6, 7), [2, 3], grad=(0,), **_CV)
case("adaptive_avg_pool2d", n(2, 4, 5, 3), 1, grad=(0,), tag="nhwc-global",
     data_format="NHWC", **_CV)
case("adaptive_avg_pool3d", n(1, 2, 4, 5, 6), 2, grad=(0,), **_CV)
case("adaptive_max_pool1d", n(2, 3, 8), 3, grad=(0,), **_CV)
case("adaptive_max_pool2d", n(2, 3, 6, 7), [2, 3], grad=(0,), **_CV)
case("adaptive_max_pool2d", ties(2, 3, 4, 4, levels=2), 2, grad=(0,),
     tag="ties", **_CV)
case("adaptive_max_pool2d", const(np.ones((1, 1, 2, 2), np.float32)), 1,
     grad=(0,), tag="all-equal", **_CV)
case("adaptive_max_pool3d", ties(1, 2, 4, 4, 4, levels=3), 2, grad=(0,),
     tag="ties", **_CV)
case("lp_pool1d", f(2, 3, 8), 2, 3, 2, grad=(0,), **_CV)
case("lp_pool2d", f(2, 3, 6, 6), 3, 2, grad=(0,), **_CV)

# vision and extended functionals
case("affine_grid", n(2, 2, 3), [2, 1, 3, 4], grad=(0,), **_CV)
case("affine_grid", n(2, 2, 3), [2, 1, 4, 3], grad=(0,), tag="half-pixel",
     align_corners=False, **_CV)
_grid = f(2, 3, 4, 2, lo=-1.1, hi=1.1)
case("grid_sample", n(2, 2, 4, 5), _grid, grad=(0, 1), **_CV)
case("grid_sample", n(2, 2, 4, 5), _grid, grad=(0, 1), tag="border",
     padding_mode="border", align_corners=False, **_CV)
case("grid_sample", n(2, 2, 4, 5), _grid, grad=(0, 1), tag="reflection",
     padding_mode="reflection", **_CV)
case("grid_sample", n(2, 2, 4, 5), _grid, grad=(0, 1),
     tag="reflection-half", padding_mode="reflection", align_corners=False,
     **_CV)
case("grid_sample", n(2, 2, 4, 5), _grid, grad=(0,), tag="nearest",
     mode="nearest", **_CV)
case("temporal_shift", n(4, 8, 2, 2), 2, grad=(0,), **_CV)
case("temporal_shift", n(6, 2, 2, 8), 3, 0.125, grad=(0,), tag="nhwc",
     data_format="NHWC", **_CV)
case("sequence_mask", const(np.array([1, 3, 0, 2])), 4)
case("sequence_mask", const(np.array([[1, 3], [2, 2]])), tag="maxlen-none",
     dtype="float32")
case("gather_tree", i(4, 2, 3, hi=9), i(4, 2, 3, hi=3))
case("class_center_sample", const(np.array([4, 1, 4, 0, 6, 1])), 8, 3)
case("margin_cross_entropy", f(4, 6, lo=-0.9, hi=0.9), i(4, hi=6),
     grad=(0,), **_CV)
case("margin_cross_entropy", f(4, 6, lo=-0.9, hi=0.9), i(4, 1, hi=6),
     grad=(0,), tag="softmax-none", margin1=1.0, margin2=0.3,
     margin3=0.1, scale=16.0, return_softmax=True, reduction="none", **_CV)
case("edit_distance", i(3, 5, hi=4), i(3, 4, hi=4))
case("edit_distance", i(3, 5, hi=4), i(3, 4, hi=4), tag="lengths",
     normalized=False, ignored_tokens=[0],
     input_length=const(np.array([5, 3, 0])),
     label_length=const(np.array([4, 2, 1])))

# geometric: the segment reductions (an empty segment included)
_seg = const(np.array([0, 0, 2, 2, 2, 3]))
for _s in ("segment_sum", "segment_mean", "segment_max", "segment_min"):
    case(_s, n(6, 3), _seg, grad=(0,), **_CV)

# vision.ops
case("box_iou", boxes(4), boxes(3), **_CV)
case("nms", boxes(8), 0.3, scores=f(8))
case("nms", boxes(8), 0.5, tag="topk-noscores", top_k=3)
case("roi_align", n(2, 3, 8, 8), boxes(3), const(np.array([2, 1])), 2,
     grad=(0, 1), **_CV)
case("roi_align", n(1, 2, 8, 8), boxes(2, 16.0), const(np.array([2])),
     [3, 2], grad=(0,), tag="scaled", spatial_scale=0.5, aligned=False,
     **_CV)


# ---------------------------------------------------------------------------
# running and comparing a case
# ---------------------------------------------------------------------------

def _seed(c: Case) -> int:
    return sum(ord(ch) * (k + 1) for k, ch in enumerate(c.id)) % (2 ** 31)


def _np(t) -> np.ndarray:
    a = np.asarray(t.numpy())
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _flat(out):
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(_flat(o))
        return res
    return [out]


def _is_float(a: np.ndarray) -> bool:
    return a.dtype.kind == "f"


def run(c: Case, paddle, ops, grads=True, tensors=None):
    """Run case ``c`` with package ``paddle`` (its ``OP_LIBRARY`` is
    ``ops``) on the current place.  Returns (outputs, gradients) as
    numpy arrays; the op's output Tensors are appended to ``tensors``
    when a list is given."""
    rng = np.random.default_rng(_seed(c))
    args = [_mat(a, rng) for a in c.args]
    kwargs = {k: _mat(v, rng) for k, v in c.kwargs.items()}
    want_grad = set(c.grad) if grads else set()
    leaves = []

    def tens(a, g):
        if isinstance(a, np.ndarray) or isinstance(a, np.generic):
            a = np.asarray(a)
            dt = c.dtype if (c.dtype and a.dtype.kind == "f") else None
            t = paddle.to_tensor(a, dtype=dt, stop_gradient=not g)
            if g:
                leaves.append(t)
            return t
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [tens(x, g) for x in a]
        return a

    targs = [tens(a, k in want_grad) for k, a in enumerate(args)]
    tkw = {k: tens(v, False) for k, v in kwargs.items()}
    outs = _flat(ops[c.name].fn(*targs, **tkw))
    if tensors is not None:
        tensors.extend(outs)
    if c.post is not None:
        outs = list(c.post(paddle, outs))
    res = [_np(o) for o in outs]
    gres = []
    if leaves:
        wrng = np.random.default_rng(12345)
        loss = None
        for o, a in zip(outs, res):
            if not _is_float(a) or a.size == 0:
                continue
            w = wrng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            term = paddle.sum(paddle.multiply(o.astype("float32"),
                                              paddle.to_tensor(w)))
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        gres = [_np(t.grad) if t.grad is not None
                else np.zeros(t.shape, np.float32) for t in leaves]
    return res, gres


def _kind(a):
    k = a.dtype.kind
    return "i" if k in "iu" else k


def _atol(c: Case, e, tol=None):
    """The absolute tolerance: ``tol`` itself in float32; in bf16
    ``tol`` times the array's largest magnitude (a bf16 sum's rounding
    scales with its terms, not with a result that cancels)."""
    tol = c.tol if tol is None else tol
    if c.dtype == "bfloat16" and e.size:
        return tol * max(float(np.max(np.abs(e))), 1.0)
    return tol


def compare(c: Case, got, want, where=""):
    """Hold run ``got`` to run ``want`` (each ``run``'s result)."""
    (outs, grads), (wouts, wgrads) = got, want
    tag = f"{c.id}{where}"
    assert len(outs) == len(wouts), f"{tag}: {len(outs)} outputs vs " \
                                    f"{len(wouts)}"
    for k, (a, e) in enumerate(zip(outs, wouts)):
        assert a.shape == e.shape, f"{tag} out {k}: shape {a.shape} vs " \
                                   f"{e.shape}"
        assert _kind(a) == _kind(e), f"{tag} out {k}: dtype {a.dtype} vs " \
                                     f"{e.dtype}"
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, e, rtol=c.tol, atol=_atol(c, e),
                                       err_msg=f"{tag} out {k}")
        else:
            np.testing.assert_array_equal(a, e, err_msg=f"{tag} out {k}")
    assert len(grads) == len(wgrads), tag
    for k, (a, e) in enumerate(zip(grads, wgrads)):
        np.testing.assert_allclose(a, e, rtol=c.gtol,
                                   atol=_atol(c, e, c.gtol),
                                   err_msg=f"{tag} grad {k}")


# ---------------------------------------------------------------------------
# random ops: laws and reproducibility
# ---------------------------------------------------------------------------

LAWS: List[Law] = []
_N = 20000


def law(name, tag=""):
    def deco(fn):
        LAWS.append(Law(name, fn, tag))
        return fn
    return deco


def _close(value, want, sd, what):
    """``value`` within 6 standard errors ``sd`` of ``want``."""
    assert abs(value - want) <= 6 * sd + 1e-6, \
        f"{what}: {value} vs {want} (±{6 * sd})"


def _moments(x, mean, std, what):
    x = np.asarray(x, np.float64).ravel()
    _close(x.mean(), mean, std / np.sqrt(x.size), f"{what} mean")
    _close(x.std(), std, std * 2 / np.sqrt(x.size), f"{what} std")


def _repro(paddle, draw, what):
    """The same seed gives the same draws; a restored state replays
    them."""
    paddle.seed(1234)
    a = _np(draw())
    paddle.seed(1234)
    np.testing.assert_array_equal(_np(draw()), a, err_msg=f"{what} seed")
    state = paddle.get_rng_state()
    c = _np(draw())
    paddle.set_rng_state(state)
    np.testing.assert_array_equal(_np(draw()), c, err_msg=f"{what} state")
    assert not np.array_equal(a, c) or a.size < 4, f"{what}: draws repeat"


@law("rand")
def _(paddle):
    x = _np(paddle.rand([_N]))
    assert x.min() >= 0 and x.max() < 1
    _moments(x, 0.5, np.sqrt(1 / 12), "rand")
    _repro(paddle, lambda: paddle.rand([64]), "rand")


@law("uniform")
def _(paddle):
    x = _np(paddle.uniform([_N], min=-2.0, max=3.0))
    assert x.min() >= -2 and x.max() < 3
    _moments(x, 0.5, 5 * np.sqrt(1 / 12), "uniform")
    _repro(paddle, lambda: paddle.uniform([64]), "uniform")


@law("randn")
def _(paddle):
    _moments(_np(paddle.randn([_N])), 0.0, 1.0, "randn")
    _repro(paddle, lambda: paddle.randn([64]), "randn")


@law("standard_normal")
def _(paddle):
    _moments(_np(paddle.standard_normal([_N])), 0.0, 1.0, "standard_normal")
    _repro(paddle, lambda: paddle.standard_normal([8, 8]), "standard_normal")


@law("gaussian")
def _(paddle):
    _moments(_np(paddle.gaussian([_N], mean=1.0, std=2.0)), 1.0, 2.0,
             "gaussian")
    _repro(paddle, lambda: paddle.gaussian([64]), "gaussian")


@law("normal")
def _(paddle):
    _moments(_np(paddle.normal(1.0, 2.0, [_N])), 1.0, 2.0, "normal")
    m = paddle.to_tensor(np.full(_N, -1.0, np.float32))
    s = paddle.to_tensor(np.full(_N, 0.5, np.float32))
    _moments(_np(paddle.normal(m, s)), -1.0, 0.5, "normal tensors")
    _repro(paddle, lambda: paddle.normal(0.0, 1.0, [64]), "normal")


@law("randint")
def _(paddle):
    x = _np(paddle.randint(0, 5, [_N]))
    assert x.dtype.kind == "i" and x.min() >= 0 and x.max() < 5
    for v in range(5):
        p = (x == v).mean()
        _close(p, 0.2, np.sqrt(0.16 / _N), f"randint freq {v}")
    _repro(paddle, lambda: paddle.randint(0, 100, [64]), "randint")


@law("randint_like")
def _(paddle):
    ref = paddle.to_tensor(np.zeros((_N,), np.float32))
    x = _np(paddle.randint_like(ref, 2, 6))
    assert x.shape == (_N,) and x.min() >= 2 and x.max() < 6
    _close(x.mean(), 3.5, np.sqrt(1.25 / _N), "randint_like mean")
    _repro(paddle, lambda: paddle.randint_like(ref, 0, 9), "randint_like")


@law("randperm")
def _(paddle):
    x = _np(paddle.randperm(50))
    assert sorted(x.tolist()) == list(range(50))
    _repro(paddle, lambda: paddle.randperm(50), "randperm")


@law("poisson")
def _(paddle):
    lam = paddle.to_tensor(np.full(_N, 3.0, np.float32))
    x = _np(paddle.poisson(lam))
    assert (x == np.round(x)).all() and x.min() >= 0
    _moments(x, 3.0, np.sqrt(3.0), "poisson")
    _repro(paddle, lambda: paddle.poisson(lam), "poisson")


@law("bernoulli")
def _(paddle):
    p = paddle.to_tensor(np.full(_N, 0.3, np.float32))
    x = _np(paddle.bernoulli(p))
    assert set(np.unique(x).tolist()) <= {0.0, 1.0}
    _close(x.mean(), 0.3, np.sqrt(0.21 / _N), "bernoulli")
    _repro(paddle, lambda: paddle.bernoulli(p), "bernoulli")


@law("multinomial")
def _(paddle):
    p = paddle.to_tensor(np.array([0.2, 0.3, 0.5], np.float32))
    x = _np(paddle.multinomial(p, _N, replacement=True))
    for v, pv in enumerate([0.2, 0.3, 0.5]):
        _close((x == v).mean(), pv, np.sqrt(pv * (1 - pv) / _N),
               f"multinomial freq {v}")
    y = _np(paddle.multinomial(p, 3))
    assert sorted(y.tolist()) == [0, 1, 2]
    _repro(paddle, lambda: paddle.multinomial(p, 64, True), "multinomial")


@law("rand_like")
def _(paddle):
    ref = paddle.to_tensor(np.zeros((_N,), np.float32))
    x = _np(paddle.rand_like(ref))
    assert x.shape == (_N,) and x.min() >= 0 and x.max() < 1
    _moments(x, 0.5, np.sqrt(1 / 12), "rand_like")
    _repro(paddle, lambda: paddle.rand_like(ref), "rand_like")


@law("randn_like")
def _(paddle):
    ref = paddle.to_tensor(np.zeros((_N,), np.float32))
    _moments(_np(paddle.randn_like(ref)), 0.0, 1.0, "randn_like")
    _repro(paddle, lambda: paddle.randn_like(ref), "randn_like")


def _inplace_draw(paddle, method, *args):
    t = paddle.to_tensor(np.zeros((_N,), np.float32))
    getattr(t, method)(*args)
    return t


@law("uniform_")
def _(paddle):
    x = _np(_inplace_draw(paddle, "uniform_", -1.0, 1.0))
    assert x.min() >= -1 and x.max() < 1
    _moments(x, 0.0, 2 * np.sqrt(1 / 12), "uniform_")
    _repro(paddle, lambda: _inplace_draw(paddle, "uniform_"), "uniform_")


@law("normal_")
def _(paddle):
    _moments(_np(_inplace_draw(paddle, "normal_", 2.0, 0.5)), 2.0, 0.5,
             "normal_")
    _repro(paddle, lambda: _inplace_draw(paddle, "normal_"), "normal_")


@law("exponential_")
def _(paddle):
    x = _np(_inplace_draw(paddle, "exponential_", 2.0))
    assert x.min() >= 0
    _moments(x, 0.5, 0.5, "exponential_")
    _repro(paddle, lambda: _inplace_draw(paddle, "exponential_"),
           "exponential_")


def _F(paddle):
    return paddle.nn.functional


@law("dropout")
def _(paddle):
    x = paddle.to_tensor(np.linspace(1, 2, _N).astype(np.float32))
    y = _np(_F(paddle).dropout(x, 0.3))
    kept = y != 0
    _close(kept.mean(), 0.7, np.sqrt(0.21 / _N), "dropout kept")
    np.testing.assert_allclose(y[kept], _np(x)[kept] / 0.7, rtol=1e-6)
    _repro(paddle, lambda: _F(paddle).dropout(x, 0.5), "dropout")


@law("dropout2d")
def _(paddle):
    x = paddle.to_tensor(np.ones((64, 32, 3, 3), np.float32))
    y = _np(_F(paddle).dropout2d(x, 0.5))
    ch = y.reshape(64, 32, 9)
    assert ((ch == 0).all(-1) | (ch == 2.0).all(-1)).all(), \
        "dropout2d: a channel is not dropped whole"
    _close((ch[..., 0] != 0).mean(), 0.5, np.sqrt(0.25 / 2048),
           "dropout2d kept")
    _repro(paddle, lambda: _F(paddle).dropout2d(x, 0.5), "dropout2d")


@law("dropout3d")
def _(paddle):
    x = paddle.to_tensor(np.ones((64, 32, 2, 2, 2), np.float32))
    y = _np(_F(paddle).dropout3d(x, 0.5)).reshape(64, 32, 8)
    assert ((y == 0).all(-1) | (y == 2.0).all(-1)).all()
    _close((y[..., 0] != 0).mean(), 0.5, np.sqrt(0.25 / 2048),
           "dropout3d kept")
    _repro(paddle, lambda: _F(paddle).dropout3d(x, 0.5), "dropout3d")


@law("alpha_dropout")
def _(paddle):
    p = 0.5
    xv = np.linspace(-1, 1, _N).astype(np.float32)
    y = _np(_F(paddle).alpha_dropout(paddle.to_tensor(xv), p))
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1 - p + alpha_p ** 2 * (1 - p) * p) ** -0.5
    bb = -a * alpha_p * p
    kept = np.isclose(y, a * xv + bb, atol=1e-5)
    dropped = np.isclose(y, a * alpha_p + bb, atol=1e-5)
    assert (kept | dropped).all()
    _close(kept.mean(), 1 - p, np.sqrt(p * (1 - p) / _N), "alpha kept")
    _repro(paddle, lambda: _F(paddle).alpha_dropout(
        paddle.to_tensor(xv[:64]), p), "alpha_dropout")


@law("gumbel_softmax")
def _(paddle):
    logits = np.log(np.array([0.2, 0.3, 0.5], np.float32))
    x = paddle.to_tensor(np.tile(logits, (_N // 4, 1)))
    y = _np(_F(paddle).gumbel_softmax(x, hard=True))
    # hard: one_hot + y - stop_gradient(y), 0 and 1 up to rounding
    assert (np.isclose(y, 0, atol=1e-6) | np.isclose(y, 1, atol=1e-6)).all()
    np.testing.assert_allclose(y.sum(-1), 1.0, atol=1e-6)
    y = np.round(y)
    for v, pv in enumerate([0.2, 0.3, 0.5]):
        _close(y[:, v].mean(), pv, np.sqrt(pv * (1 - pv) / y.shape[0]),
               f"gumbel freq {v}")
    s = _np(_F(paddle).gumbel_softmax(x, temperature=0.5))
    np.testing.assert_allclose(s.sum(-1), 1.0, rtol=1e-5)
    _repro(paddle, lambda: _F(paddle).gumbel_softmax(x[:8]), "gumbel")


@law("rrelu")
def _(paddle):
    xv = -np.linspace(0.1, 1, _N).astype(np.float32)
    y = _np(_F(paddle).rrelu(paddle.to_tensor(xv), 0.1, 0.3))
    slope = y / xv
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    _close(slope.mean(), 0.2, 0.2 / np.sqrt(3 * _N), "rrelu slope")
    pos = _np(_F(paddle).rrelu(paddle.to_tensor(-xv)))
    np.testing.assert_array_equal(pos, -xv)
    _repro(paddle, lambda: _F(paddle).rrelu(paddle.to_tensor(xv[:64])),
           "rrelu")


@law("create_parameter")
def _(paddle):
    w = paddle.create_parameter([200, 100], "float32")
    x = _np(w)
    limit = np.sqrt(6.0 / 300)
    assert x.shape == (200, 100) and np.abs(x).max() <= limit
    assert not w.stop_gradient
    _moments(x, 0.0, limit / np.sqrt(3), "xavier")
    _repro(paddle, lambda: paddle.create_parameter([8, 8], "float32"),
           "create_parameter")


def covered_ops():
    """Every op name a case covers."""
    return {c.name for c in PARITY} | {c.name for c in LAWS}
