"""Linear algebra ops (the port of ``paddle_tpu/tensor/linalg.py``).

``matmul`` is ``torch.matmul``; the decompositions are
``torch.linalg``'s, with numpy's conventions where the reference
follows ``jnp.linalg`` (``lu``'s 1-based pivots, ``lstsq``'s SVD
solution and residuals, ``eigh`` of the symmetrized input).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply_op
from ..ops.registry import register, _ensure_tensor, promote

__all__ = [
    "matmul", "bmm", "dot", "mv", "t", "norm", "dist", "cond", "cross",
    "cholesky", "cholesky_solve", "qr", "svd", "inv", "det", "slogdet",
    "solve", "triangular_solve", "eig", "eigh", "eigvals", "eigvalsh",
    "matrix_power", "matrix_rank", "pinv", "lstsq", "lu", "multi_dot",
    "corrcoef", "cov", "householder_product", "matrix_transpose",
]

_INF = ("inf", float("inf"))
_NINF = ("-inf", float("-inf"))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """paddle.matmul."""
    x, y = _ensure_tensor(x), _ensure_tensor(y)

    def _f(a, b):
        a, b = promote(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(_f, x, y, op_name="matmul")


def bmm(x, y, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: torch.matmul(*promote(a, b)), x, y,
                    op_name="bmm")


def dot(x, y, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: torch.sum(a * b, -1), x, y, op_name="dot")


def mv(x, vec, name=None):
    x, vec = _ensure_tensor(x), _ensure_tensor(vec)
    return apply_op(lambda a, b: torch.matmul(*promote(a, b)), x, vec,
                    op_name="mv")


def t(x, name=None):
    x = _ensure_tensor(x)
    if x.ndim > 2:
        raise ValueError("paddle.t only supports ndim<=2; use transpose")
    return apply_op(lambda a: a.T if a.dim() == 2 else a, x, op_name="t")


def matrix_transpose(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: a.transpose(-1, -2), x,
                    op_name="matrix_transpose")


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = _ensure_tensor(x)
    if p is None:
        p = 2

    def _f(a):
        if axis is None:
            flat = a.reshape(-1)
            if p in ("fro", 2, 2.0):
                out = torch.sqrt(torch.sum(flat * flat))
                return out.reshape([1] * a.dim()) if keepdim else out
            if p in _INF:
                return torch.amax(torch.abs(flat))
            return torch.sum(torch.abs(flat) ** p) ** (1.0 / p)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if isinstance(ax, tuple) or p == "fro":
            return torch.linalg.norm(a, ord=p, dim=ax, keepdim=keepdim)
        if p in _INF:
            return torch.amax(torch.abs(a), dim=ax, keepdim=keepdim)
        if p in _NINF:
            return torch.amin(torch.abs(a), dim=ax, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=ax, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, dim=ax,
                         keepdim=keepdim) ** (1.0 / p)
    return apply_op(_f, x, op_name="norm")


def dist(x, y, p=2, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)

    def _f(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return apply_op(_f, x, y, op_name="dist")


def cond(x, p=None, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.linalg.cond(a, p), x, op_name="cond")


def cross(x, y, axis=9, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    if axis == 9:  # paddle default: first axis of length 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return apply_op(lambda a, b: torch.linalg.cross(*promote(a, b), dim=axis),
                    x, y, op_name="cross")


def cholesky(x, upper=False, name=None):
    x = _ensure_tensor(x)

    def _f(a):
        lo = torch.linalg.cholesky(a)
        return lo.transpose(-1, -2) if upper else lo
    return apply_op(_f, x, op_name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    # only the factor's own triangle is read (and gets a gradient)
    return apply_op(lambda b, chol: torch.cholesky_solve(
        b, torch.triu(chol) if upper else torch.tril(chol), upper=upper),
        x, y, op_name="cholesky_solve")


def qr(x, mode="reduced", name=None):
    x = _ensure_tensor(x)
    q, r = apply_op(lambda a: tuple(torch.linalg.qr(a, mode=mode)), x,
                    op_name="qr")
    return q, r


def svd(x, full_matrices=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(
        lambda a: tuple(torch.linalg.svd(a, full_matrices=full_matrices)),
        x, op_name="svd")


def inv(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(torch.linalg.inv, x, op_name="inv")


def det(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(torch.linalg.det, x, op_name="det")


def slogdet(x, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.stack(list(torch.linalg.slogdet(a)), 0),
                    x, op_name="slogdet")


def solve(x, y, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: torch.linalg.solve(*promote(a, b)), x, y,
                    op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)

    def _f(a, b):
        if transpose:
            a = a.transpose(-1, -2)
        return torch.linalg.solve_triangular(
            a, b, upper=(upper != transpose), unitriangular=unitriangular)
    return apply_op(_f, x, y, op_name="triangular_solve")


def eig(x, name=None):
    x = _ensure_tensor(x)
    w, v = torch.linalg.eig(x._t.detach())
    return Tensor._wrap(w), Tensor._wrap(v)


def eigh(x, UPLO="L", name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: tuple(torch.linalg.eigh((a + a.mH) / 2,
                                                      UPLO=UPLO)),
                    x, op_name="eigh")


def eigvals(x, name=None):
    x = _ensure_tensor(x)
    return Tensor._wrap(torch.linalg.eigvals(x._t.detach()))


def eigvalsh(x, UPLO="L", name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x,
                    op_name="eigvalsh")


def matrix_power(x, n, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.linalg.matrix_power(a, n), x,
                    op_name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.linalg.matrix_rank(a, rtol=tol), x,
                    op_name="matrix_rank")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x,
                    op_name="pinv")


def _lstsq(a, b, rcond):
    """``jnp.linalg.lstsq``: the SVD solution, the residuals
    ``|b - a x|^2`` per column, the rank and the singular values."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape[-2:]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1).to(torch.int32)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    x = vh.mH @ (s_inv[..., :, None] * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=-2) ** 2
    if vec:
        x = x.reshape(-1)
    return x, resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    x, y = _ensure_tensor(x), _ensure_tensor(y)
    return apply_op(lambda a, b: _lstsq(*promote(a, b), rcond), x, y,
                    op_name="lstsq")


def lu(x, pivot=True, get_infos=False, name=None):
    x = _ensure_tensor(x)
    # paddle's LAPACK 1-based sequential-swap pivots, as lu_factor gives
    lu_, piv = apply_op(lambda a: tuple(torch.linalg.lu_factor(a)), x,
                        op_name="lu")
    if get_infos:
        info = torch.zeros([1], dtype=torch.int32, device=x._t.device)
        return lu_, piv, Tensor._wrap(info)
    return lu_, piv


def multi_dot(x, name=None):
    tensors = [_ensure_tensor(t) for t in x]
    return apply_op(lambda *arrs: torch.linalg.multi_dot(list(arrs)),
                    *tensors, op_name="multi_dot")


def corrcoef(x, rowvar=True, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.corrcoef(a if rowvar else a.T), x,
                    op_name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = _ensure_tensor(x)
    return apply_op(lambda a: torch.cov(a if rowvar else a.T,
                                        correction=1 if ddof else 0), x,
                    op_name="cov")


def householder_product(x, tau, name=None):
    x, tau = _ensure_tensor(x), _ensure_tensor(tau)
    return apply_op(torch.linalg.householder_product, x, tau,
                    op_name="householder_product")


for _n in __all__:
    register(_n, globals()[_n])
