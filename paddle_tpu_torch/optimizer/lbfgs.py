"""L-BFGS (the port of ``paddle_tpu/optimizer/lbfgs.py``): closure-driven,
the two-loop recursion and an optional strong-Wolfe line search.

The direction is built on the device in float32 (rho, alpha and beta
stay 0-d tensors, so building it reads nothing back); the loop's control
runs on the host, and every decision reads its scalars in one stacked
transfer (``_fetch``): (|g|_inf, g·d) an iteration, (f, g·d) a line
search evaluation, (f, s·y, |s|_inf) after a step.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, enable_grad, no_grad
from .optimizer import Optimizer

__all__ = ["LBFGS"]

F32 = torch.float32


def _flat(tensors):
    return torch.cat([t.reshape(-1).to(F32) for t in tensors])


def _fetch(*scalars):
    """0-d device scalars stacked and read by the host at once."""
    return [float(v) for v in torch.stack(scalars).cpu().tolist()]


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []

    # -- flat views --------------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if not p.stop_gradient]

    def _gather(self):
        return _flat([p._t.detach() for p in self._params()])

    def _gather_grad(self):
        gs = []
        for p in self._params():
            g = p.grad
            gs.append(torch.zeros_like(p._t) if g is None else g._t)
        return _flat(gs)

    def _scatter(self, flat):
        off = 0
        for p in self._params():
            n = p._t.numel()
            p._set_array(flat[off:off + n].reshape(p._t.shape)
                         .to(p._t.dtype))
            off += n

    # -- closure evaluation ------------------------------------------------
    def _evaluate(self, closure, x):
        """(loss, grad) as device tensors: the loss rides the caller's
        next fused read."""
        self._scatter(x)
        self.clear_grad()
        loss = closure()
        arr = loss._t if isinstance(loss, Tensor) else torch.as_tensor(loss)
        return arr.detach().to(F32).reshape(()), self._gather_grad()

    def _eval_with_gtd(self, closure, x, d):
        f_dev, g = self._evaluate(closure, x)
        f, gtd = _fetch(f_dev, torch.dot(g, d))
        return f, g, gtd

    def _direction(self, g):
        """The two-loop recursion over the (s, y) history, on the
        device."""
        q = -g
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    @no_grad()
    def step(self, closure=None):
        assert closure is not None, \
            "LBFGS.step requires a closure that recomputes the loss"

        def closure_with_grad():
            with enable_grad():
                return closure()

        x = self._gather()
        loss_dev, g = self._evaluate(closure_with_grad, x)
        loss, = _fetch(loss_dev)
        evals = 1
        for _ in range(self.max_iter):
            d = self._direction(g)
            g_max, gtd = _fetch(torch.max(torch.abs(g)), torch.dot(g, d))
            if g_max <= self.tolerance_grad:
                break
            if gtd > -1e-15:  # not a descent direction: reset the history
                self._s_hist.clear()
                self._y_hist.clear()
                d = -g
                gtd, = _fetch(-torch.dot(g, g))
            t = float(self.get_lr())
            if self.line_search_fn == "strong_wolfe":
                loss_new, g_new, t, ls_evals = self._strong_wolfe(
                    closure_with_grad, x, d, t, loss, g, gtd)
                evals += ls_evals
                x_new = x + t * d
                s = x_new - x
                y = g_new - g
                sy, s_max = _fetch(torch.dot(s, y), torch.max(torch.abs(s)))
            else:
                x_new = x + t * d
                loss_new_dev, g_new = self._evaluate(closure_with_grad,
                                                     x_new)
                evals += 1
                s = x_new - x
                y = g_new - g
                loss_new, sy, s_max = _fetch(
                    loss_new_dev, torch.dot(s, y), torch.max(torch.abs(s)))
            if sy > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
            done = abs(loss_new - loss) < self.tolerance_change or \
                s_max < self.tolerance_change
            x, loss, g = x_new, loss_new, g_new
            if done or evals >= self.max_eval:
                break
        self._scatter(x)
        self._step_count += 1
        return Tensor(torch.tensor(loss, dtype=F32, device=x.device))

    def _strong_wolfe(self, closure, x, d, t, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_ls=25):
        """Doubling, then zoom, to a step with the strong Wolfe
        conditions (the reference's search); one host read an
        evaluation."""
        evals = 0
        t_prev, f_prev = 0.0, f0
        f_new, g_new = f0, g0
        for i in range(max_ls):
            f_new, g_new, gtd_new = self._eval_with_gtd(closure,
                                                        x + t * d, d)
            evals += 1
            if f_new > f0 + c1 * t * gtd0 or (i > 0 and f_new >= f_prev):
                lo, hi = t_prev, t
                f_lo = f_prev
                for _ in range(max_ls):
                    t_mid = 0.5 * (lo + hi)
                    f_mid, g_mid, gtd_mid = self._eval_with_gtd(
                        closure, x + t_mid * d, d)
                    evals += 1
                    if f_mid > f0 + c1 * t_mid * gtd0 or f_mid >= f_lo:
                        hi = t_mid
                    else:
                        if abs(gtd_mid) <= -c2 * gtd0:
                            return f_mid, g_mid, t_mid, evals
                        if gtd_mid * (hi - lo) >= 0:
                            hi = lo
                        lo, f_lo = t_mid, f_mid
                    if abs(hi - lo) < 1e-9:
                        break
                return f_mid, g_mid, t_mid, evals
            if abs(gtd_new) <= -c2 * gtd0:
                return f_new, g_new, t, evals
            if gtd_new >= 0:
                lo, hi = t, t_prev
                for _ in range(max_ls):
                    t_mid = 0.5 * (lo + hi)
                    f_mid, g_mid, gtd_mid = self._eval_with_gtd(
                        closure, x + t_mid * d, d)
                    evals += 1
                    if f_mid > f0 + c1 * t_mid * gtd0:
                        hi = t_mid
                    else:
                        if abs(gtd_mid) <= -c2 * gtd0:
                            return f_mid, g_mid, t_mid, evals
                        lo = t_mid
                    if abs(hi - lo) < 1e-9:
                        break
                return f_mid, g_mid, t_mid, evals
            t_prev, f_prev = t, f_new
            t = t * 2.0
        # max_ls ran out: (f_new, g_new) were evaluated at t_prev
        return f_new, g_new, t_prev, evals
