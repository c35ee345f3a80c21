"""Math ops (the port of ``paddle_tpu/tensor/math.py``).

Each op is one torch function, or a short composition of them where the
reference's jnp function has no torch twin with the same semantics
(``median`` averages the two middles as ``jnp.median`` does, ``mean`` of
an integer tensor is a float, ``outer`` flattens its inputs, ...).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply_op, rebind_inplace, tape_snapshot
from ..ops.registry import unary_op, binary_op, register, _ensure_tensor

__all__ = [
    # elementwise unary
    "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "floor",
    "ceil", "round", "trunc", "frac", "sign", "sgn", "reciprocal",
    "sigmoid", "logit", "digamma", "lgamma", "angle", "conj", "real",
    "imag", "deg2rad", "rad2deg", "i0", "isnan", "isinf", "isfinite",
    # elementwise binary
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "hypot", "heaviside", "copysign", "nextafter", "logaddexp",
    "gcd", "lcm", "ldexp", "inner", "outer", "kron",
    # bitwise
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    # reductions / scans
    "sum", "mean", "prod", "nansum", "nanmean", "max", "min", "amax",
    "amin", "all", "any", "std", "var", "median", "quantile", "logsumexp",
    "count_nonzero", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp",
    # misc
    "scale", "clip", "lerp", "add_n", "multiplex", "trace", "diagonal",
    "diff", "stanh", "nan_to_num", "increment", "rsqrt_",
]


def _float(a):
    """Integer and bool inputs as the default float (jnp's rule for
    the transcendental ops and means)."""
    if a.is_floating_point() or a.is_complex():
        return a
    from ..core.dtype import get_default_dtype
    return a.to(get_default_dtype())


def _f1(fn):
    return lambda a: fn(_float(a))


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
abs = unary_op("abs", torch.abs)  # noqa: A001
neg = unary_op("neg", torch.neg)
exp = unary_op("exp", _f1(torch.exp))
expm1 = unary_op("expm1", _f1(torch.expm1))
log = unary_op("log", _f1(torch.log))
log2 = unary_op("log2", _f1(torch.log2))
log10 = unary_op("log10", _f1(torch.log10))
log1p = unary_op("log1p", _f1(torch.log1p))
sqrt = unary_op("sqrt", _f1(torch.sqrt))
rsqrt = unary_op("rsqrt", _f1(torch.rsqrt))
square = unary_op("square", torch.square)
sin = unary_op("sin", _f1(torch.sin))
cos = unary_op("cos", _f1(torch.cos))
tan = unary_op("tan", _f1(torch.tan))
asin = unary_op("asin", _f1(torch.asin))
acos = unary_op("acos", _f1(torch.acos))
atan = unary_op("atan", _f1(torch.atan))
sinh = unary_op("sinh", _f1(torch.sinh))
cosh = unary_op("cosh", _f1(torch.cosh))
tanh = unary_op("tanh", _f1(torch.tanh))
asinh = unary_op("asinh", _f1(torch.asinh))
acosh = unary_op("acosh", _f1(torch.acosh))
atanh = unary_op("atanh", _f1(torch.atanh))
erf = unary_op("erf", _f1(torch.erf))
erfinv = unary_op("erfinv", _f1(torch.erfinv))
floor = unary_op("floor", torch.floor)
ceil = unary_op("ceil", torch.ceil)
round = unary_op("round", torch.round)  # noqa: A001 - half to even
trunc = unary_op("trunc", torch.trunc)
frac = unary_op("frac", lambda x: x - torch.trunc(x))
sign = unary_op("sign", torch.sgn)
sgn = unary_op("sgn", torch.sgn)
reciprocal = unary_op("reciprocal", _f1(torch.reciprocal))
sigmoid = unary_op("sigmoid", _f1(torch.sigmoid))
logit = unary_op("logit", _f1(lambda x: torch.log(x / (1 - x))))
digamma = unary_op("digamma", _f1(torch.digamma))
lgamma = unary_op("lgamma", _f1(torch.lgamma))
angle = unary_op("angle", _f1(torch.angle))
conj = unary_op("conj", lambda x: torch.conj_physical(x) if x.is_complex()
                else x)
real = unary_op("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = unary_op("imag", lambda x: torch.imag(x) if x.is_complex()
                else torch.where(torch.ones_like(x, dtype=torch.bool),
                                 torch.zeros((), dtype=x.dtype,
                                             device=x.device), x))
deg2rad = unary_op("deg2rad", _f1(torch.deg2rad))
rad2deg = unary_op("rad2deg", _f1(torch.rad2deg))
i0 = unary_op("i0", _f1(torch.special.i0))
isnan = unary_op("isnan", torch.isnan)
isinf = unary_op("isinf", torch.isinf)
isfinite = unary_op("isfinite", torch.isfinite)

# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------
add = binary_op("add", torch.add)
subtract = binary_op("subtract", torch.subtract)
multiply = binary_op("multiply", torch.multiply)
divide = binary_op("divide", lambda a, b: torch.true_divide(_float(a), b))
floor_divide = binary_op("floor_divide", torch.floor_divide)
mod = binary_op("mod", torch.remainder)
remainder = binary_op("remainder", torch.remainder)
floor_mod = remainder
pow = binary_op("pow", torch.pow)  # noqa: A001
maximum = binary_op("maximum", torch.maximum)
minimum = binary_op("minimum", torch.minimum)
fmax = binary_op("fmax", torch.fmax)
fmin = binary_op("fmin", torch.fmin)
atan2 = binary_op("atan2", lambda a, b: torch.atan2(_float(a), _float(b)))
hypot = binary_op("hypot", lambda a, b: torch.hypot(_float(a), _float(b)))
heaviside = binary_op("heaviside", torch.heaviside)
copysign = binary_op("copysign", torch.copysign)
nextafter = binary_op("nextafter", torch.nextafter)
logaddexp = binary_op("logaddexp",
                      lambda a, b: torch.logaddexp(_float(a), _float(b)))
gcd = binary_op("gcd", torch.gcd)
lcm = binary_op("lcm", torch.lcm)
ldexp = binary_op("ldexp", lambda a, b: torch.ldexp(_float(a), b))
inner = binary_op("inner", torch.inner)
outer = binary_op("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                    b.reshape(-1)))
kron = binary_op("kron", torch.kron)

# bitwise
bitwise_and = binary_op("bitwise_and", torch.bitwise_and)
bitwise_or = binary_op("bitwise_or", torch.bitwise_or)
bitwise_xor = binary_op("bitwise_xor", torch.bitwise_xor)
bitwise_not = unary_op("bitwise_not", torch.bitwise_not)
bitwise_left_shift = binary_op("bitwise_left_shift",
                               torch.bitwise_left_shift)
bitwise_right_shift = binary_op("bitwise_right_shift",
                                torch.bitwise_right_shift)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """The reduced axes as a tuple (all of them for None)."""
    axis = _axis(axis)
    if axis is None:
        return tuple(range(a.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _to_last(a, axis):
    """``a`` with the axes of ``axis`` merged into one last axis, and the
    shape a keepdim result takes."""
    dims = sorted(d % a.dim() for d in _dims(a, axis)) if a.dim() else []
    keep = [1 if i in dims else s for i, s in enumerate(a.shape)]
    rest = [i for i in range(a.dim()) if i not in dims]
    moved = a.permute(rest + dims) if a.dim() else a
    return moved.reshape([a.shape[i] for i in rest] + [-1]), keep


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduction(name, tfn, floats=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = _ensure_tensor(x)
        kw = {}
        if dtype is not None:
            from ..core import dtype as dtype_mod
            kw["dtype"] = dtype_mod.convert_dtype(dtype)

        def _f(a):
            if floats and not kw:
                a = _float(a)
            return tfn(a, dim=_dims(a, axis), keepdim=keepdim, **kw)
        return apply_op(_f, x, op_name=name or op.__name__)
    op.__name__ = name
    register(name, op)
    return op


def _prod(a, dim, keepdim, dtype=None):
    if dtype is not None:
        a = a.to(dtype)
    if not a.dim():
        return a.clone()
    for d in sorted((d % a.dim() for d in dim), reverse=True):
        a = torch.prod(a, dim=d, keepdim=keepdim)
    return a


sum = _reduction("sum", torch.sum)  # noqa: A001
mean = _reduction("mean", torch.mean, floats=True)
prod = _reduction("prod", _prod)
nansum = _reduction("nansum", torch.nansum)
nanmean = _reduction("nanmean", torch.nanmean, floats=True)


def _cmp_reduction(name, tfn):
    def op(x, axis=None, keepdim=False, name=None):
        x = _ensure_tensor(x)
        return apply_op(lambda a: tfn(a, dim=_dims(a, axis),
                                      keepdim=keepdim),
                        x, op_name=name or op.__name__)
    op.__name__ = name
    register(name, op)
    return op


def _all(a, dim, keepdim):
    return torch.all(a, dim=dim, keepdim=keepdim) if dim else a.bool()


def _any(a, dim, keepdim):
    return torch.any(a, dim=dim, keepdim=keepdim) if dim else a.bool()


def _amax(a, dim, keepdim):
    return torch.amax(a, dim=dim, keepdim=keepdim) if dim else a.clone()


def _amin(a, dim, keepdim):
    return torch.amin(a, dim=dim, keepdim=keepdim) if dim else a.clone()


max = _cmp_reduction("max", _amax)  # noqa: A001
min = _cmp_reduction("min", _amin)  # noqa: A001
amax = _cmp_reduction("amax", _amax)
amin = _cmp_reduction("amin", _amin)
all = _cmp_reduction("all", _all)  # noqa: A001
any = _cmp_reduction("any", _any)  # noqa: A001


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _ensure_tensor(x)
    ddof = 1 if unbiased else 0
    return apply_op(lambda a: torch.std(_float(a), dim=_dims(a, axis),
                                        correction=ddof, keepdim=keepdim),
                    x, op_name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _ensure_tensor(x)
    ddof = 1 if unbiased else 0
    return apply_op(lambda a: torch.var(_float(a), dim=_dims(a, axis),
                                        correction=ddof, keepdim=keepdim),
                    x, op_name="var")


def _quantile(a, q, axis, keepdim, method):
    a = _float(a)
    dt = a.dtype
    flat, keep = _to_last(a if dt in (torch.float32, torch.float64)
                          else a.float(), axis)
    qt = torch.as_tensor(q, dtype=flat.dtype, device=a.device)
    out = torch.quantile(flat, qt, dim=-1, interpolation=method)
    if keepdim:
        out = out.reshape(list(qt.shape) + keep)
    return out.to(dt)


def median(x, axis=None, keepdim=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: _quantile(a, 0.5, axis, keepdim, "linear"),
                    x, op_name="median")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    x = _ensure_tensor(x)
    if isinstance(q, Tensor):
        q = q.tolist()
    return apply_op(lambda a: _quantile(a, q, axis, keepdim, interpolation),
                    x, op_name="quantile")


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.logsumexp(_float(a), dim=_dims(a, axis),
                                              keepdim=keepdim),
                    x, op_name="logsumexp")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        dims = _dims(a, axis)
        out = torch.count_nonzero(a, dim=dims) if dims \
            else (a != 0).long()
        if keepdim:
            for d in sorted(d % a.dim() for d in dims):
                out = out.unsqueeze(d)
        return out
    return apply_op(_f, x, op_name="count_nonzero")


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def cumsum(x, axis=None, dtype=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0)
        return torch.cumsum(a, int(axis))
    return apply_op(_f, x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0)
        return torch.cumprod(a, int(dim))
    return apply_op(_f, x, op_name="cumprod")


def _cum_arg(name, scan):
    """The running extreme and the last index where it was reached (the
    reference's scan over ``where(a == vals, index, -1)``)."""
    def op(x, axis=None, dtype="int64", name=None):
        x = _ensure_tensor(x)

        def _f(a):
            aa = a.reshape(-1) if axis is None else a
            ax = 0 if axis is None else int(axis) % aa.dim()
            vals = scan(aa, ax).values
            shape = [-1 if i == ax else 1 for i in range(aa.dim())]
            idx = torch.arange(aa.shape[ax], device=a.device).reshape(shape)
            idx = torch.where(aa == vals, idx, -1)
            return vals, torch.cummax(idx, ax).values.long()
        return apply_op(_f, x, op_name=name)
    op.__name__ = name
    return op


cummax = _cum_arg("cummax", torch.cummax)
cummin = _cum_arg("cummin", torch.cummin)


def logcumsumexp(x, axis=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if axis is None:
            return torch.logcumsumexp(_float(a).reshape(-1), 0)
        return torch.logcumsumexp(_float(a), int(axis))
    return apply_op(_f, x, op_name="logcumsumexp")


# ---------------------------------------------------------------------------
# misc math
# ---------------------------------------------------------------------------

def _const(v, like):
    """A Python number or a Tensor (as a constant) in ``like``'s dtype."""
    v = v._t.detach() if isinstance(v, Tensor) else v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        if bias_after_scale:
            return a * _const(scale, a) + _const(bias, a)
        return (a + _const(bias, a)) * _const(scale, a)
    out = apply_op(_f, x, op_name="scale")
    if act == "relu":
        return apply_op(lambda a: torch.clamp(a, min=0), out, op_name="relu")
    return out


def clip(x, min=None, max=None, name=None):  # noqa: A002
    x = _ensure_tensor(x)
    mn = min._t.detach() if isinstance(min, Tensor) else min
    mx = max._t.detach() if isinstance(max, Tensor) else max
    return apply_op(lambda a: torch.clamp(a, mn, mx), x, op_name="clip")


def lerp(x, y, weight, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    if isinstance(weight, Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight,
                        op_name="lerp")
    return apply_op(lambda a, b: a + weight * (b - a), x, y, op_name="lerp")


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    tensors = [_ensure_tensor(t) for t in inputs]

    def _f(*arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out
    return apply_op(_f, *tensors, op_name="add_n")


def multiplex(inputs, index, name=None):
    tensors = [_ensure_tensor(t) for t in inputs]
    index = _ensure_tensor(index)

    def _f(idx, *arrs):
        stacked = torch.stack(arrs, 0)
        sel = idx.reshape(-1).long()
        return stacked[sel, torch.arange(stacked.shape[1],
                                         device=stacked.device)]
    return apply_op(_f, index, *tensors, op_name="multiplex")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2)
                    .sum(-1), x, op_name="trace")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2),
                    x, op_name="diagonal")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = _ensure_tensor(x)
    extra = []
    if prepend is not None:
        extra.append(_ensure_tensor(prepend))
    if append is not None:
        extra.append(_ensure_tensor(append))

    def _f(a, *rest):
        i = 0
        pre = app = None
        if prepend is not None:
            pre = rest[i]
            i += 1
        if append is not None:
            app = rest[i]
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)
    return apply_op(_f, x, *extra, op_name="diff")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * a), x,
                    op_name="stanh")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                               neginf=neginf), x,
                    op_name="nan_to_num")


def increment(x, value=1.0, name=None):
    x = _ensure_tensor(x)
    out = apply_op(lambda a: a + _const(value, a), tape_snapshot(x),
                   op_name="increment")
    return rebind_inplace(x, out)


def rsqrt_(x):
    x._set_array(torch.rsqrt(x._t))
    return x


for _n in ["std", "var", "median", "quantile", "logsumexp", "cumsum",
           "cumprod", "cummax", "cummin", "logcumsumexp", "scale", "clip",
           "lerp", "add_n", "multiplex", "trace", "diagonal", "diff",
           "stanh", "nan_to_num", "increment", "count_nonzero"]:
    register(_n, globals()[_n])


def clip_by_norm(x, max_norm, name=None):
    """Scale x so its L2 norm is at most max_norm."""
    x = _ensure_tensor(x)
    return apply_op(
        lambda a: a * torch.clamp(
            max_norm / torch.clamp(torch.sqrt(torch.sum(a.float() ** 2)),
                                   min=1e-12), max=1.0).to(a.dtype),
        x, op_name="clip_by_norm")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` renormalized to p-norm at most
    max_norm."""
    x = _ensure_tensor(x)

    def _f(a):
        a32 = a.float()
        reduce_axes = tuple(i for i in range(a.dim()) if i != axis % a.dim())
        norms = torch.sum(torch.abs(a32) ** p, dim=reduce_axes,
                          keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm,
                             max_norm / torch.clamp(norms, min=1e-12),
                             torch.ones_like(norms))
        return (a32 * factor).to(a.dtype)

    return apply_op(_f, x, op_name="renorm")


register("clip_by_norm", clip_by_norm)
register("renorm", renorm)
__all__ += ["clip_by_norm", "renorm"]
