"""Random sampling ops (the port of ``paddle_tpu/tensor/random.py``).

Every draw takes the global generator of the device it draws on
(``framework.random``), or a generator seeded with ``seed`` where the op
takes one.  Draws differ from JAX's; their laws are the same.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..core.place import current_device
from ..core import dtype as dtype_mod
from ..framework.random import generator_for
from ..ops.registry import register, _ensure_tensor

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "gaussian", "standard_normal", "poisson", "bernoulli",
    "multinomial", "exponential_", "uniform_", "normal_", "rand_like",
    "randn_like",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(v) for v in shape.tolist()]
    if isinstance(shape, int):
        return [shape]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    return d if d is not None else (default or dtype_mod.get_default_dtype())


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator_for(device)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    t = torch.randn(_shape_list(shape), generator=_gen(dev, seed),
                    dtype=_dt(dtype), device=dev)
    return Tensor._wrap(t * std + mean)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._t.detach() if isinstance(mean, Tensor) else mean
        s = std._t.detach() if isinstance(std, Tensor) else std
        ref = m if torch.is_tensor(m) else s
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape)
        t = torch.randn(shp, generator=generator_for(ref.device),
                        device=ref.device)
        return Tensor._wrap(t * s + m)
    return gaussian(shape if shape is not None else [1], mean, std)


def standard_normal(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype=dtype)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = current_device()
    t = torch.rand(_shape_list(shape), generator=_gen(dev, seed),
                   dtype=_dt(dtype), device=dev)
    return Tensor._wrap(t * (max - min) + min)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    t = torch.randint(low, high, _shape_list(shape),
                      generator=generator_for(dev), device=dev,
                      dtype=_dt(dtype, torch.int64))
    return Tensor._wrap(t)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = _ensure_tensor(x)
    return randint(low, high, x.shape, dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    t = torch.randperm(n, generator=generator_for(dev), device=dev)
    return Tensor._wrap(t.to(_dt(dtype, torch.int64)))


def poisson(x, name=None):
    x = _ensure_tensor(x)
    a = x._t.detach()
    return Tensor._wrap(torch.poisson(a.float(), generator_for(a.device))
                        .to(a.dtype))


def bernoulli(x, name=None):
    x = _ensure_tensor(x)
    a = x._t.detach()
    return Tensor._wrap(torch.bernoulli(a, generator=generator_for(a.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = _ensure_tensor(x)
    a = x._t.detach()
    return Tensor._wrap(torch.multinomial(a, num_samples, replacement,
                                          generator=generator_for(a.device)))


def rand_like(x, dtype=None, name=None):
    x = _ensure_tensor(x)
    return uniform(x.shape, dtype or x.dtype, 0.0, 1.0)


def randn_like(x, dtype=None, name=None):
    x = _ensure_tensor(x)
    return gaussian(x.shape, dtype=dtype or x.dtype)


# in-place variants (Tensor methods)

def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    a = x._t
    t = torch.rand(a.shape, generator=_gen(a.device, seed), dtype=a.dtype,
                   device=a.device)
    x._set_array(t * (max - min) + min)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    a = x._t
    t = torch.randn(a.shape, generator=generator_for(a.device),
                    dtype=a.dtype, device=a.device)
    x._set_array(t * std + mean)
    return x


def exponential_(x, lam=1.0, name=None):
    a = x._t
    t = torch.empty(a.shape, dtype=a.dtype, device=a.device).exponential_(
        1.0, generator=generator_for(a.device))
    x._set_array(t / lam)
    return x


for _n in __all__:
    register(_n, globals()[_n])
