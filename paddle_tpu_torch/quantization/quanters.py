"""Quanters and observers (the port of ``paddle_tpu/quantization/
quanters.py``).

Reference analog: python/paddle/quantization/base_quanter.py:25
(BaseQuanter), quanters/abs_max.py:25/:94 (FakeQuanterWithAbsMaxObserver
factory + layer), imperative/ptq_quantizer.py (the PTQ observer family).

The scales live in float32 buffers on the observed tensors' device.
``KLObserver`` keeps the reference's host-side numpy reservoir and
entropy search line for line, so the same batches give the same
threshold bit for bit; each observed activation is copied to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import current_device
from ..core.tensor import Tensor, apply_op
from ..nn.layer.layers import Layer
from .functional import fake_quant_dequant

__all__ = ["BaseQuanter", "quanter", "QuanterFactory",
           "FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer",
           "AbsmaxObserver", "MovingAverageAbsmaxObserver", "KLObserver"]


def _scalar(value):
    return Tensor._wrap(torch.full([], float(value), dtype=torch.float32,
                                   device=current_device()))


class BaseQuanter(Layer):
    """reference: base_quanter.py:25 — abstract fake-quant layer exposing
    scales/zero_points/bit_length/quant_axis for export."""

    def scales(self):
        raise NotImplementedError

    def zero_points(self):  # symmetric schemes: always zero
        return None

    @property
    def bit_length(self):
        return getattr(self, "_bits", 8)

    @property
    def quant_axis(self):
        return getattr(self, "_quant_axis", None)


class QuanterFactory:
    """reference: factory.py:52 — holds (cls, args) and instantiates per
    wrapped layer; lets QuantConfig carry configured-but-unbuilt quanters."""

    def __init__(self, cls, *args, **kwargs):
        self.cls = cls
        self.args = args
        self.kwargs = kwargs

    def _instance(self, layer=None):
        return self.cls(*self.args, **self.kwargs)


def quanter(class_name):
    """reference: factory.py:73 — decorator declaring a factory alias for a
    quanter layer class; the factory lands in this module's namespace."""
    def wrap(cls):
        def make(*args, **kwargs):
            return QuanterFactory(cls, *args, **kwargs)
        make.__name__ = class_name
        globals()[class_name] = make
        return cls
    return wrap


def _absmax(arr, quant_axis):
    a = arr.detach().abs()
    if quant_axis is None:
        return a.amax().float()
    axes = tuple(i for i in range(a.dim()) if i != quant_axis)
    return a.amax(dim=axes).float()


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """Moving-average absmax fake quanter
    (reference: quanters/abs_max.py:94)."""

    def __init__(self, layer=None, moving_rate=0.9, bit_length=8,
                 quant_axis=None, dtype="float32", name=None):
        super().__init__()
        self._moving_rate = moving_rate
        self._bits = bit_length
        self._quant_axis = quant_axis
        self.register_buffer("_scale", _scalar(1.0))
        self.register_buffer("_state", _scalar(1.0))
        self.register_buffer("_accum", _scalar(1.0))
        # flips on the first training-mode observation; the int8 freeze
        # refuses quanters that never saw data (scale would be the
        # meaningless init of 1.0). A BUFFER so it survives the
        # state_dict roundtrip — a QAT model restored from checkpoint
        # must still be freezable.
        self.register_buffer("_seen_data", _scalar(0.0))

    @property
    def _updated(self) -> bool:
        return bool(float(self._seen_data._t) > 0)

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                self._seen_data._t = torch.ones_like(self._seen_data._t)
                absmax = _absmax(x._t, self._quant_axis)
                if self._scale._t.shape != absmax.shape:
                    # first per-channel observation: grow the scalar
                    # buffers
                    self._state._t = torch.ones_like(absmax)
                    self._accum._t = torch.ones_like(absmax)
                r = self._moving_rate
                state = self._state._t * r + 1.0
                accum = self._accum._t * r + absmax
                self._state._t = state
                self._accum._t = accum
                self._scale._t = accum / state
        return apply_op(fake_quant_dequant, x, self._scale._t,
                        op_name="fake_quant", bits=self._bits,
                        quant_axis=self._quant_axis)

    def scales(self):
        return Tensor._wrap(self._scale._t)


# the reference's public factory name
@quanter("FakeQuanterWithAbsMaxObserver")
class _FQAbsMax(FakeQuanterWithAbsMaxObserverLayer):
    pass


class AbsmaxObserver(BaseQuanter):
    """PTQ collector: tracks the max |x| seen; forward is identity
    (reference: imperative/ptq_quantizer.py AbsmaxQuantizer)."""

    def __init__(self, bit_length=8, quant_axis=None):
        super().__init__()
        self._bits = bit_length
        self._quant_axis = quant_axis
        self.register_buffer("_scale", _scalar(0.0))

    def forward(self, x):
        with torch.no_grad():
            absmax = _absmax(x._t, self._quant_axis)
            if self._quant_axis is not None and self._scale._t.dim() == 0:
                self._scale._t = torch.zeros_like(absmax)
            self._scale._t = torch.maximum(
                self._scale._t.to(absmax.device), absmax)
        return x

    def scales(self):
        return Tensor._wrap(self._scale._t)


class KLObserver(BaseQuanter):
    """PTQ collector choosing the clip threshold by KL divergence
    (reference: imperative/ptq_quantizer.py KLQuantizer; the TensorRT
    entropy-calibration algorithm).

    Absmax calibration lets one outlier blow up the scale and waste the
    int8 range on values that never occur; KL picks the threshold T
    whose clipped-and-quantized distribution stays closest (min KL) to
    the observed one. Keeps a bounded reservoir sample of |x| across
    calibration batches; ``scales()`` runs an iterative range-shrinking
    entropy search once and caches the result.
    """

    _RESERVOIR = 200_000

    def __init__(self, bit_length=8, bins=2048):
        super().__init__()
        self._bits = bit_length
        self._bins = int(bins)
        self._samples = np.zeros(0, np.float32)  # reservoir of |x|
        self._seen = 0
        self._rng = np.random.default_rng(0)
        self.register_buffer("_scale", _scalar(0.0))
        self._dirty = False

    def forward(self, x):
        # the host copy of every observed activation (the reference's
        # np.asarray of the device array)
        a = np.abs(x._t.detach().to(torch.float32).cpu().numpy()
                   ).reshape(-1)
        self._seen += a.size
        # bounded reservoir: a single coarse histogram loses the bulk's
        # resolution when one outlier stretches the range; raw samples
        # let scales() iterate the range down (uniform via subsampling)
        if self._samples.size + a.size <= self._RESERVOIR:
            self._samples = np.concatenate([self._samples, a])
        else:
            keep = self._RESERVOIR - self._samples.size
            if keep > 0:
                self._samples = np.concatenate(
                    [self._samples,
                     self._rng.choice(a, size=keep, replace=False)])
            else:
                # replace a fraction proportional to the new batch
                n_rep = max(1, int(self._RESERVOIR * a.size
                                   / max(self._seen, 1)))
                n_rep = min(n_rep, a.size, self._RESERVOIR)
                idx = self._rng.choice(self._RESERVOIR, size=n_rep,
                                       replace=False)
                self._samples[idx] = self._rng.choice(
                    a, size=n_rep, replace=False)
        self._dirty = True
        return x

    def _kl_search(self, hist: np.ndarray, bin_w: float,
                   bins: int) -> float:
        """One entropy-calibration pass: for candidate bin counts i,
        clip the tail into bin i-1, quantize the head into 2^(bits-1)
        levels, keep the i minimizing KL(P || Q)."""
        n_levels = 2 ** (self._bits - 1)  # 128 magnitude levels
        best_i, best_kl = bins, np.inf
        for i in range(n_levels, bins + 1, 8):
            p = hist[:i].astype(np.float64).copy()
            p[i - 1] += hist[i:].sum()
            psum = p.sum()
            if psum == 0:
                continue
            p /= psum
            q = np.zeros(i, np.float64)
            for c in np.array_split(np.arange(i), n_levels):
                seg = hist[c]
                nz = seg > 0
                if nz.any():
                    q[c[nz]] = seg.sum() / nz.sum()
            qsum = q.sum()
            if qsum == 0:
                continue
            q /= qsum
            mask = p > 0
            kl = float(np.sum(p[mask] * np.log(
                p[mask] / np.maximum(q[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_i = kl, i
        return best_i * bin_w

    def _kl_threshold(self) -> float:
        s = self._samples
        if s.size == 0:
            return 0.0
        rng_hi = float(s.max())
        if rng_hi == 0.0:
            return 0.0
        # with few samples the sparse histogram makes KL noise-dominated
        # and over-aggressive; (a) size the bins to the sample count,
        # (b) never clip more than 0.01% of the observed mass (the
        # HistQuantizer-style percentile floor)
        bins = int(min(self._bins, max(256, s.size // 4)))
        floor = float(np.quantile(s, 1.0 - 1e-4))
        # iterate: each round histograms the CLIPPED samples over the
        # previous threshold, recovering bulk resolution an outlier-
        # stretched first range destroyed
        for _ in range(4):
            hist, _ = np.histogram(np.minimum(s, rng_hi),
                                   bins=bins, range=(0.0, rng_hi))
            t = self._kl_search(hist.astype(np.float64),
                                rng_hi / bins, bins)
            t = max(t, floor)
            if t >= rng_hi * 0.95:
                break
            rng_hi = t
        return max(rng_hi, floor)

    def scales(self):
        if self._dirty:
            self._scale._t = torch.tensor(
                self._kl_threshold(), dtype=torch.float32,
                device=self._scale._t.device)
            self._dirty = False
        return Tensor._wrap(self._scale._t)


class MovingAverageAbsmaxObserver(BaseQuanter):
    """PTQ collector with EMA smoothing
    (reference: imperative/ptq_quantizer.py KLQuantizer-family sibling)."""

    def __init__(self, bit_length=8, moving_rate=0.9):
        super().__init__()
        self._bits = bit_length
        self._moving_rate = moving_rate
        self.register_buffer("_scale", _scalar(0.0))
        self._seen = False

    def forward(self, x):
        with torch.no_grad():
            absmax = _absmax(x._t, None)
            if not self._seen:
                self._scale._t = absmax
                self._seen = True
            else:
                r = self._moving_rate
                self._scale._t = self._scale._t * r + absmax * (1 - r)
        return x

    def scales(self):
        return Tensor._wrap(self._scale._t)
