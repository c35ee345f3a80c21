"""Optimizers (the port of ``paddle_tpu/optimizer/optimizer.py``): the
Optimizer base, SGD, Momentum, Adagrad, Adam, AdamW, Adamax, RMSProp,
Adadelta, Lamb and LarsMomentum.

``loss.backward(); opt.step(); opt.clear_grad()``.  A step runs per
parameter, one torch op per jnp op of the reference's update: the grad
cast to float32, float32 accumulators, the result cast back to the
parameter's dtype and written into the parameter's own storage (under
``torch.no_grad()``), so a ``Parameter`` stays the same leaf.  AdamW's
arithmetic is the reference's (``p - lr m̂/(√v̂ + ε) - lr wd p``), not
``torch.optim.AdamW``'s.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..core.tensor import Tensor, _as_torch, no_grad
from .lr import LRScheduler

F32 = torch.float32

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Adadelta", "Lamb", "LarsMomentum"]


class _StepStats:
    """Tensor-stats telemetry for one optimizer step (FLAGS_tpu_metrics):
    global grad norm, per-param rms / abs-max / zero-fraction, and the
    weight-update ratio ||Δw|| / ||w||, the numbers that make a bf16
    divergence attributable before it becomes a NaN.  The scalars stay
    on the device; ONE host sync happens in finish(), and the disabled
    path adds a dict lookup."""

    def __init__(self, params_grads):
        self._gauges = []  # (metric_name, param_label, torch scalar)
        self._grad_sq = []
        self._param_sq = []
        self._upd_sq = []
        for i, (p, g) in enumerate(params_grads):
            if g is None:
                continue
            garr = g._t.to(F32)
            name = p.name or f"param_{i}"
            sq = torch.sum(garr * garr)
            self._grad_sq.append(sq)
            n = max(int(garr.numel()), 1)
            self._gauges.append(("grad_rms", name, torch.sqrt(sq / n)))
            zero = torch.zeros((), dtype=F32, device=garr.device)
            absmax = torch.amax(torch.abs(garr)) if garr.numel() else zero
            self._gauges.append(("grad_absmax", name, absmax))
            zf = torch.mean((garr == 0).to(F32)) if garr.numel() else zero
            self._gauges.append(("grad_zero_fraction", name, zf))

    @staticmethod
    def begin(params_grads):
        """None unless metrics are on and grads exist."""
        from ..profiler import metrics as _metrics
        if not _metrics.enabled():
            return None
        if not any(g is not None for _, g in params_grads):
            return None
        return _StepStats(params_grads)

    def note_update(self, old32, new32):
        self._param_sq.append(torch.sum(old32 * old32))
        d = new32 - old32
        self._upd_sq.append(torch.sum(d * d))

    def finish(self):
        from ..profiler import metrics as _metrics, numerics as _numerics
        dev = self._grad_sq[0].device if self._grad_sq else "cpu"
        zero = torch.zeros((), dtype=F32, device=dev)

        def norm(sqs):
            return torch.sqrt(sum(sqs)) if sqs else zero
        scalars = [v for _, _, v in self._gauges]
        scalars += [norm(self._grad_sq), norm(self._param_sq),
                    norm(self._upd_sq)]
        vals = torch.stack(scalars).cpu().numpy()  # the one host sync
        for (metric, label, _), v in zip(self._gauges, vals):
            _metrics.gauge(metric, labels_help[metric],
                           param=label).set(float(v))
        gn, pn, un = (float(x) for x in vals[len(self._gauges):])
        _metrics.gauge("grad_global_norm",
                       "Global L2 norm of gradients at step").set(gn)
        _metrics.gauge("param_global_norm",
                       "Global L2 norm of parameters at step").set(pn)
        ratio = un / pn if pn > 0 else 0.0
        _metrics.gauge("weight_update_ratio",
                       "||param update|| / ||param|| per step").set(ratio)
        if not np.isfinite(gn):
            _metrics.counter(
                "nonfinite_grad_steps_total",
                "Optimizer steps whose global grad norm was NaN/Inf"
            ).inc()
        _numerics.note("grad_global_norm", gn)
        _numerics.note("param_global_norm", pn)
        _numerics.note("weight_update_ratio", ratio)


labels_help = {
    "grad_rms": "Per-parameter RMS of the gradient",
    "grad_absmax": "Per-parameter max |grad|",
    "grad_zero_fraction": "Per-parameter fraction of exactly-zero grads",
}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if parameters is None:
            from ..static.program import recording_program
            if recording_program() is None:
                raise ValueError(
                    "parameters is required in eager mode (no global "
                    "program); pass model.parameters(). In static mode "
                    "(enable_static) minimize() binds the program's "
                    "trainable variables automatically.")
            parameters = []  # filled by the Executor from the program
        self._parameter_list = list(parameters)
        self._lr = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float) or isinstance(weight_decay, int):
            self._weight_decay = float(weight_decay)
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:  # L2Decay-like object with a coeff
            self._weight_decay = float(getattr(weight_decay, "_coeff",
                                               getattr(weight_decay,
                                                       "coeff", 0.0)))
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -- accumulators ------------------------------------------------------
    def _acc(self, name, p, init=None):
        store = self._accumulators.setdefault(name, {})
        key = id(p)
        if key not in store:
            store[key] = init if init is not None \
                else torch.zeros_like(p._t, dtype=F32)
        return store[key]

    def _set_acc(self, name, p, value):
        self._accumulators[name][id(p)] = value

    # -- step --------------------------------------------------------------
    @no_grad()
    def step(self):
        from ..profiler import _record_span, metrics as _metrics
        rec = _metrics.enabled()
        t0 = time.perf_counter() if rec else None
        with _record_span("optimizer_step"):
            self._step_impl()
        if rec:
            _metrics.counter("optimizer_steps_total",
                             "Optimizer.step() calls").inc()
            _metrics.histogram(
                "optimizer_step_seconds",
                "Host wall time of Optimizer.step()").observe(
                    time.perf_counter() - t0)

    def _step_impl(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if not p.stop_gradient and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        stats = _StepStats.begin(params_grads)
        for p, g in params_grads:
            if g is None:
                continue
            garr = g._t.to(F32)
            if self._use_decoupled_wd():
                pass  # applied inside _update for AdamW
            elif self._weight_decay:
                garr = garr + self._weight_decay * p._t.to(F32)
            lr = self.get_lr() * p.optimize_attr.get("learning_rate", 1.0) \
                if hasattr(p, "optimize_attr") else self.get_lr()
            if getattr(self, "_use_master_weights", False) \
                    and p._t.dtype in (torch.bfloat16, torch.float16):
                # AMP O2 (``amp.decorate``): the update runs on a float32
                # master made at the first step from the low-precision
                # param; the param becomes the master's cast
                master = self._accumulators.get("master_weight", {}).get(
                    id(p))
                if master is None:
                    master = self._acc("master_weight", p,
                                       init=p._t.to(F32))
                low = p._t
                p._t = master     # the update (AdamW's decay) reads f32
                try:
                    new = self._update(p, garr, lr).to(F32)
                finally:
                    p._t = low
                self._set_acc("master_weight", p, new)
                p._set_array(new.to(low.dtype))
                if stats is not None:
                    stats.note_update(master, new)
            else:
                old32 = p._t.to(F32) if stats is not None else None
                new = self._update(p, garr, lr)
                p._set_array(new.to(p._t.dtype))
                if stats is not None:
                    stats.note_update(old32, new.to(F32))
        if stats is not None:
            stats.finish()

    def _use_decoupled_wd(self):
        return False

    def _update(self, p, g, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from ..static.program import recording_program
        prog = recording_program()
        if prog is not None:
            # static build: register the objective; Executor.run computes
            # the gradients in its replay and steps this optimizer
            # (reference: minimize appends backward + optimizer ops)
            prog._opt = (self, loss)
            return None, []
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # -- state -------------------------------------------------------------
    def state_dict(self):
        sd = {}
        name_of = {id(p): (p.name or f"param_{i}")
                   for i, p in enumerate(self._parameter_list)}
        for acc_name, store in self._accumulators.items():
            for pid, arr in store.items():
                if pid in name_of:
                    sd[f"{name_of[pid]}_{acc_name}"] = Tensor._wrap(arr)
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        name_of = {(p.name or f"param_{i}"): p
                   for i, p in enumerate(self._parameter_list)}
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        # longest-name-first so a param name that is a prefix of another
        # ("linear" vs "linear_2") cannot steal the longer param's state
        by_len = sorted(name_of.items(), key=lambda kv: -len(kv[0]))
        for key, val in state_dict.items():
            if key in ("LR_Scheduler", "@step"):
                continue
            for pname, p in by_len:
                if key.startswith(pname + "_"):
                    acc_name = key[len(pname) + 1:]
                    arr = _as_torch(val._t if isinstance(val, Tensor)
                                    else val, F32, p._t.device).clone()
                    self._accumulators.setdefault(acc_name, {})[id(p)] = arr
                    break

    load_dict = set_state_dict


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, p, g, lr):
        return p._t.to(F32) - lr * g


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, lr):
        v = self._acc("velocity", p)
        v_new = self._momentum * v + g
        self._set_acc("velocity", p, v_new)
        if self._nesterov:
            return p._t.to(F32) - lr * (
                g + self._momentum * v_new)
        return p._t.to(F32) - lr * v_new


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, initial_accumulator_value=0.0,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, p, g, lr):
        m = self._acc("moment", p,
                      torch.full_like(p._t, self._init_acc,
                                       dtype=F32))
        m_new = m + g * g
        self._set_acc("moment", p, m_new)
        return p._t.to(F32) - lr * g / (
            torch.sqrt(m_new) + self._epsilon)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, p, g, lr):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        t = self._step_count
        m_new = self._beta1 * m + (1 - self._beta1) * g
        v_new = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m_new)
        self._set_acc("moment2", p, v_new)
        m_hat = m_new / (1 - self._beta1 ** t)
        v_hat = v_new / (1 - self._beta2 ** t)
        return p._t.to(F32) - lr * m_hat / (
            torch.sqrt(v_hat) + self._epsilon)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = float(weight_decay) if not hasattr(
            weight_decay, "_coeff") else float(weight_decay._coeff)
        self._apply_decay_fn = apply_decay_param_fun

    def _use_decoupled_wd(self):
        return True

    def _update(self, p, g, lr):
        new = super()._update(p, g, lr)
        decay = self._wd_coeff
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                p.name):
            decay = 0.0
        if decay:
            new = new - lr * decay * p._t.to(F32)
        return new


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, p, g, lr):
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        t = self._step_count
        m_new = self._beta1 * m + (1 - self._beta1) * g
        u_new = torch.maximum(self._beta2 * u, torch.abs(g))
        self._set_acc("moment", p, m_new)
        self._set_acc("inf_norm", p, u_new)
        return p._t.to(F32) - lr / (1 - self._beta1 ** t) \
            * m_new / (u_new + self._epsilon)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, p, g, lr):
        ms = self._acc("mean_square", p)
        ms_new = self._rho * ms + (1 - self._rho) * g * g
        self._set_acc("mean_square", p, ms_new)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg_new = self._rho * mg + (1 - self._rho) * g
            self._set_acc("mean_grad", p, mg_new)
            denom = torch.sqrt(ms_new - mg_new * mg_new + self._epsilon)
        else:
            denom = torch.sqrt(ms_new + self._epsilon)
        mom = self._acc("momentum", p)
        mom_new = self._momentum * mom + lr * g / denom
        self._set_acc("momentum", p, mom_new)
        return p._t.to(F32) - mom_new


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon

    def _update(self, p, g, lr):
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        avg_sq_new = self._rho * avg_sq + (1 - self._rho) * g * g
        upd = torch.sqrt(avg_upd + self._epsilon) \
            / torch.sqrt(avg_sq_new + self._epsilon) * g
        avg_upd_new = self._rho * avg_upd + (1 - self._rho) * upd * upd
        self._set_acc("avg_squared_grad", p, avg_sq_new)
        self._set_acc("avg_squared_update", p, avg_upd_new)
        return p._t.to(F32) - lr * upd


class LarsMomentum(Optimizer):
    """LARS: layer-wise adaptive rate scaling over momentum SGD — the
    large-batch training optimizer (ResNet at 32k batch).

    Reference: fleet/meta_optimizers/lars_optimizer.py +
    optimizer.LarsMomentumOptimizer (lars_momentum kernel):

        local_lr = lr * lars_coeff * ||w|| /
                   (||g|| + lars_weight_decay * ||w|| + epsilon)
        v        = momentum * v + local_lr * (g + lars_weight_decay * w)
        w        = w - v

    ``exclude_from_weight_decay``: substrings of parameter names (bias,
    batch-norm scales) whose trust ratio drops the decay term, matching
    the reference's name-match exclusion.
    """

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, epsilon=0.0,
                 exclude_from_weight_decay=None, grad_clip=None,
                 name=None):
        # lars_weight_decay lives inside the trust ratio; the base
        # class's additive decay must stay off
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = float(momentum)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])

    def _update(self, p, g, lr):
        v = self._acc("velocity", p)
        w = p._t.to(F32)
        wd = self._lars_wd
        if self._exclude and any(s in (p.name or "")
                                 for s in self._exclude):
            wd = 0.0
        w_norm = torch.linalg.vector_norm(w)
        g_norm = torch.linalg.vector_norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm
            / (g_norm + wd * w_norm + self._epsilon),
            torch.full_like(w_norm, lr))
        v_new = self._momentum * v + local_lr * (g + wd * w)
        self._set_acc("velocity", p, v_new)
        return w - v_new


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, lr):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        t = self._step_count
        m_new = self._beta1 * m + (1 - self._beta1) * g
        v_new = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m_new)
        self._set_acc("moment2", p, v_new)
        m_hat = m_new / (1 - self._beta1 ** t)
        v_hat = v_new / (1 - self._beta2 ** t)
        r = m_hat / (torch.sqrt(v_hat) + self._epsilon)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        p32 = p._t.to(F32)
        update = r + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        return p32 - lr * trust * update
