"""Gradient clipping (the port of ``paddle_tpu/nn/clip.py``):
ClipGradByValue / ByNorm / ByGlobalNorm, which optimizers apply before
their update, and the ``clip_grad_*_`` helpers."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _skip(p, g):
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


def _scaled(g, scale):
    """g * scale as the reference computes it: a float32 product (a bf16
    gradient times the float32 scale promotes) cast back to g's dtype."""
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, params_grads):
        return [(p, g) if _skip(p, g) else
                (p, Tensor._wrap(torch.clamp(g._t, self.min, self.max)))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g._t.float() ** 2))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, Tensor._wrap(_scaled(g._t, scale))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        sq = [torch.sum(g._t.float() ** 2) for p, g in params_grads
              if not _skip(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        scale = torch.clamp(self.clip_norm
                            / torch.clamp(global_norm, min=1e-12), max=1.0)
        self._record_norms(global_norm)
        return [(p, g) if _skip(p, g) else
                (p, Tensor._wrap(_scaled(g._t, scale)))
                for p, g in params_grads]

    def _record_norms(self, global_norm):
        """FLAGS_tpu_metrics: the pre- and post-clip global grad norms
        (post-clip pins at clip_norm while pre-clip keeps climbing, the
        sign of a divergence before the update).  Off: one dict lookup."""
        from ..profiler import metrics as _metrics
        if not _metrics.enabled():
            return
        pre = float(global_norm)
        post = min(pre, self.clip_norm)
        _metrics.gauge("grad_global_norm_preclip",
                       "Global grad norm before ClipGradByGlobalNorm"
                       ).set(pre)
        _metrics.gauge("grad_global_norm_postclip",
                       "Global grad norm after ClipGradByGlobalNorm"
                       ).set(post)
        if pre > self.clip_norm:
            _metrics.counter("grad_clip_activations_total",
                             "Steps where global-norm clipping engaged"
                             ).inc()
        from ..profiler import numerics as _numerics
        _numerics.note("grad_global_norm_preclip", pre)
        _numerics.note("grad_global_norm_postclip", post)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return Tensor._wrap(torch.tensor(0.0))
    if norm_type == float("inf"):
        total = torch.amax(torch.stack([torch.amax(torch.abs(g._t))
                                        for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(g._t.float()) ** norm_type)
             for g in grads])) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = _scaled(p.grad._t, scale)
    return Tensor._wrap(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad._t, -clip_value, clip_value)
