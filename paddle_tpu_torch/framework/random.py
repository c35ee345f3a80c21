"""The global random state of the eager core.

The port of ``paddle_tpu/framework/random.py``.  The reference keeps one
JAX key and folds a draw counter into it; here ``paddle.seed`` seeds one
``torch.Generator`` per device, made on first use (importing creates
none), and every draw of the eager core (``paddle.rand``, dropout masks,
initializers) takes the generator of the device it draws on.  Draws
differ from JAX's by construction; the same seed gives the same draws,
and ``set_rng_state(get_rng_state())`` replays them.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "Generator",
           "default_generator", "generator_for"]


class Generator:
    """One seed over a ``torch.Generator`` per device."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self._gens = {}
        return self

    def for_device(self, device) -> torch.Generator:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(self._seed)
                self._gens[key] = gen
            return gen

    def get_state(self):
        """{"seed": s, device: the generator's state} for every device
        drawn on so far."""
        with self._lock:
            state = {k: g.get_state() for k, g in self._gens.items()}
        state["seed"] = self._seed
        return state

    def set_state(self, state):
        state = dict(state)
        self.manual_seed(state.pop("seed"))
        for key, st in state.items():
            self.for_device(key).set_state(st)
        return self

    def initial_seed(self):
        return self._seed


default_generator = Generator(np.random.randint(0, 2**31 - 1))


def seed(value: int):
    """paddle.seed: reseeds the global generator on every device."""
    default_generator.manual_seed(int(value))
    return default_generator


def generator_for(device) -> torch.Generator:
    return default_generator.for_device(device)


def get_rng_state():
    return default_generator.get_state()


def set_rng_state(state):
    default_generator.set_state(state)
