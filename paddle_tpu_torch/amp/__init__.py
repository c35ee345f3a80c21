"""paddle.amp: mixed precision (the port of ``paddle_tpu/amp/``).

``auto_cast`` / ``amp_guard`` cast an op's floating ``Tensor`` inputs
by its O1 / O2 list in ``apply_op`` (``core/tensor.py``'s cast hook);
``decorate`` O2 casts a model's parameters to the low dtype, keeps the
norm layers' in float32 and gives the optimizers float32 master
weights; ``GradScaler`` scales the loss, unscales the gradients to
float32 with one finiteness read, skips a non-finite step and adapts
the scale.  ``debugging`` is the tensor checker.

A cast is ``.to(dtype)`` in torch's graph, so a gradient returns in the
input's own dtype; the reference differentiates after its cast, so a
float32 input of a white-list op gets its gradient in the low dtype
(equal values, summed in the low dtype where an input feeds several
ops).
"""
from __future__ import annotations

import threading

import torch

from ..core import dtype as dtype_mod
from ..core import tensor as _tensor_mod
from ..core.tensor import Tensor

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "white_list", "black_list", "debugging"]

# O1 lists (reference: python/paddle/amp/auto_cast.py:135-149); an op
# matches by the last part of its ``op_name``
WHITE_LIST = {"matmul", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
              "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
              "einsum", "scaled_dot_product_attention"}
BLACK_LIST = {"exp", "square", "log", "log2", "log10", "log1p", "mean",
              "sum", "cos_sim", "softmax", "log_softmax",
              "softmax_with_cross_entropy", "cross_entropy",
              "sigmoid_focal_loss", "binary_cross_entropy", "cumsum",
              "layer_norm", "batch_norm", "rms_norm", "norm", "logsumexp",
              "erf", "erfinv"}


def white_list():
    return {"float16": {"O1": WHITE_LIST, "O2": WHITE_LIST},
            "bfloat16": {"O1": WHITE_LIST, "O2": WHITE_LIST}}


def black_list():
    return {"float16": {"O1": BLACK_LIST, "O2": set()},
            "bfloat16": {"O1": BLACK_LIST, "O2": set()}}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_STATE = _AmpState()


def amp_state():
    return _STATE


class auto_cast:
    """Context manager: ``with paddle.amp.auto_cast(level='O1'): ...``;
    nests, and restores the enclosing state on exit."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.custom_white = set(custom_white_list or [])
        self.custom_black = set(custom_black_list or [])

    def __enter__(self):
        self._saved = (_STATE.enabled, _STATE.dtype, _STATE.level,
                       _STATE.custom_white, _STATE.custom_black)
        _STATE.enabled = self.enable
        _STATE.dtype = self.dtype
        _STATE.level = self.level
        _STATE.custom_white = self.custom_white
        _STATE.custom_black = self.custom_black
        return self

    def __exit__(self, *exc):
        (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.custom_white,
         _STATE.custom_black) = self._saved
        return False


amp_guard = auto_cast


def _cast_all(inputs, dtype):
    return [Tensor._wrap(x._t.to(dtype))
            if isinstance(x, Tensor) and x._t.is_floating_point()
            and x._t.dtype != dtype else x
            for x in inputs]


def amp_cast_inputs(op_name, inputs):
    """``apply_op``'s hook while AMP is on: under O1 a white-list op's
    floating ``Tensor`` inputs go to the low dtype, a black-list op's to
    float32, others stay; under O2 all go to the low dtype but a
    black-list op's, which go to float32.  Other inputs pass as they
    are."""
    if not _STATE.enabled:
        return inputs
    name = op_name.split(".")[-1]
    white = (WHITE_LIST | _STATE.custom_white) - _STATE.custom_black
    black = (BLACK_LIST | _STATE.custom_black) - _STATE.custom_white
    if name in black:
        return _cast_all(inputs, torch.float32)
    if _STATE.level == "O2" or name in white:
        return _cast_all(inputs, _STATE.dtype)
    return inputs


_tensor_mod._AMP_STATE = _STATE
_tensor_mod._AMP_CAST_HOOK[0] = amp_cast_inputs


# per-optimizer unscale bookkeeping (reference: grad_scaler.py
# OptimizerState READY / UNSCALED / STEPPED): what keeps
# ``scaler.unscale_(opt); clip; scaler.step(opt)`` from dividing the
# gradients by the scale twice
_READY, _UNSCALED, _STEPPED = "ready", "unscaled", "stepped"


class GradScaler:
    """Dynamic loss scaling (reference: grad_scaler.py:AmpScaler).

    Telemetry (FLAGS_tpu_metrics): the ``amp_loss_scale`` gauge and the
    ``amp_found_inf_total`` / ``amp_skipped_steps_total`` counters,
    mirrored into the Profiler's numerics section.
    """

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # id(optimizer) -> _READY / _UNSCALED / _STEPPED, cleared by update()
        self._opt_states: dict = {}

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale_grads(self, optimizer):
        """Every gradient as float32 divided by the scale, and one fused
        finiteness check read by the host once."""
        inv = 1.0 / self._scale
        params = [p for p in optimizer._parameter_list
                  if p.grad is not None]
        if not params:
            self._found_inf = False
            return
        unscaled = [p.grad._t.to(torch.float32) * inv for p in params]
        flags = torch.stack([torch.all(torch.isfinite(g))
                             for g in unscaled])
        found = not bool(torch.all(flags))     # the one host read
        for p, g in zip(params, unscaled):
            p.grad = g
        self._found_inf = found
        if found:
            from ..profiler import metrics as _metrics, \
                numerics as _numerics
            if _metrics.enabled():
                _metrics.counter(
                    "amp_found_inf_total",
                    "Unscale passes that found non-finite grads").inc()
            if _numerics.enabled():
                _numerics.record_site(
                    "grad_scaler.unscale", True,
                    {"nan": -1, "inf": -1, "size": len(params),
                     "shape": [], "dtype": "float32"})

    def unscale_(self, optimizer):
        """Explicit unscale (for clipping between unscale and step);
        twice before ``step()`` / ``update()`` raises."""
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer), _READY)
        if state == _UNSCALED:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        if state == _STEPPED:
            raise RuntimeError(
                "unscale_() is being called after step(); call update() "
                "first")
        self._unscale_grads(optimizer)
        self._opt_states[id(optimizer)] = _UNSCALED

    def step(self, optimizer):
        """Unscale (once) unless ``unscale_`` ran, then step unless a
        gradient was non-finite.  The scale moves in ``update()``."""
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), _READY)
        if state == _STEPPED:
            raise RuntimeError(
                "step() has already been called on this optimizer since "
                "the last update()")
        if state != _UNSCALED:
            self._unscale_grads(optimizer)
        if not self._found_inf:
            optimizer.step()
        else:
            from ..profiler import metrics as _metrics
            if _metrics.enabled():
                _metrics.counter(
                    "amp_skipped_steps_total",
                    "Optimizer steps skipped on non-finite grads").inc()
        self._opt_states[id(optimizer)] = _STEPPED

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        self._opt_states.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
            self._found_inf = False
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        from ..profiler import metrics as _metrics, numerics as _numerics
        if _metrics.enabled():
            _metrics.gauge("amp_loss_scale",
                           "Current dynamic loss scale").set(self._scale)
        _numerics.note("loss_scale", self._scale)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        if not self._enable:
            return {"enable": False}
        return {"enable": self._enable,
                "use_dynamic_loss_scaling": self._dynamic,
                "scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._enable = bool(sd.get("enable", self._enable))
        if not self._enable:
            return
        self._dynamic = bool(sd.get("use_dynamic_loss_scaling",
                                    self._dynamic))
        self._scale = float(sd.get("scale", self._scale))
        self._incr_ratio = sd.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = sd.get("decr_ratio", self._decr_ratio)
        self._incr_every = sd.get("incr_every_n_steps", self._incr_every)
        self._decr_every = sd.get("decr_every_n_nan_or_inf",
                                  self._decr_every)
        self._good_steps = int(sd.get("good_steps", 0))
        self._bad_steps = int(sd.get("bad_steps", 0))


def _norm_param_ids(model):
    """ids of the parameters normalization layers own: O2 keeps them
    float32 (reference: amp_decorate's keep_batch_norm_fp32)."""
    from ..nn.layer import norm as _norm

    norm_types = (_norm._BatchNormBase, _norm.LayerNorm, _norm.RMSNorm,
                  _norm.GroupNorm, _norm._InstanceNormBase)
    ids = set()
    for layer in model.sublayers(include_self=True):
        if isinstance(layer, norm_types):
            for p in layer.parameters(include_sublayers=False):
                ids.add(id(p))
    return ids


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate (the reference's second, effective
    definition): O2 casts each model's float32 / float64 parameters to
    the low dtype (new leaves; the norm layers' stay float32) and marks
    the optimizers for float32 master weights unless ``master_weight``
    is False.  O1 changes nothing.  Returns (models, optimizers) in the
    single / list structure they came in."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    single_opt = optimizers is not None and \
        not isinstance(optimizers, (list, tuple))
    opt_list = [] if optimizers is None else (
        [optimizers] if single_opt else list(optimizers))

    if level == "O2":
        low = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        for m in model_list:
            keep_fp32 = _norm_param_ids(m)
            for p in m.parameters():
                if id(p) in keep_fp32:
                    continue
                if p._t.dtype in (torch.float32, torch.float64):
                    req = p._t.requires_grad
                    p._t = p._t.detach().to(low).requires_grad_(req)
                    p.clear_grad()
        for opt in opt_list:
            if master_weight is not False:
                opt._use_master_weights = True

    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    return models_out, (opt_list[0] if single_opt else opt_list)


from . import debugging  # noqa: E402,F401
