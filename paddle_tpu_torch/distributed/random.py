"""Named random states for model parallelism (the port of
``paddle_tpu/distributed/random.py``; Paddle's
``fleet/layers/mpu/random.py``).

A dropout inside a tensor-parallel region must draw a different mask on
each ``mp`` rank (each holds other columns), while replicated regions
draw the same mask everywhere.  ``RNGStatesTracker`` keeps named
``framework.random.Generator``s; inside ``rng_state(name)`` that
generator is the global one, so every draw of the eager core (dropout,
``paddle.rand``) takes its state, and the global generator is back on
exit.  ``model_parallel_random_seed(seed)`` seeds the global generator
with ``seed`` on every rank and the tracker's ``model_parallel_rng``
with ``seed + 1024 + the mp rank``.
"""
from __future__ import annotations

import contextlib

from ..framework import random as global_rng
from ..framework.random import Generator

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = Generator(seed)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = states

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        saved = global_rng.default_generator
        global_rng.default_generator = self.states_[name]
        try:
            yield
        finally:
            global_rng.default_generator = saved


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the global generator with ``seed`` (the same on every rank)
    and the tracker's ``model_parallel_rng`` with ``seed + 1024 + mp
    rank`` (the topology's ``mp`` index; 0 without one)."""
    import random as pyrandom
    from .mesh import get_topology
    seed = seed or (pyrandom.randint(0, 2 ** 30) + 100)
    topo = get_topology(create=False)
    mp_rank = topo.axis_index("mp") if topo is not None and topo.member \
        else 0
    _TRACKER.reset()
    global_rng.seed(seed)
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
