"""``paddle.distributed.io`` (the port of
``paddle_tpu/distributed/io.py``): a static ``Program``'s persistable
state saved and loaded through ``framework.io``."""
from __future__ import annotations

import os

__all__ = ["save_persistables", "load_persistables", "is_persistable"]


def is_persistable(var) -> bool:
    """A parameter or buffer persists; an activation does not (any
    ``Tensor`` not marked temporary)."""
    from ..core.tensor import Tensor
    return isinstance(var, Tensor) and not getattr(
        var, "_is_temporary", False)


def _program(main_program):
    if main_program is not None:
        return main_program
    from ..static.program import default_main_program
    return default_main_program()


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Save the program's persistable state (``Program.state_dict``)
    under ``dirname``; ``executor`` is taken for the signature."""
    from ..framework.io import save
    state = _program(main_program).state_dict()
    os.makedirs(dirname, exist_ok=True)
    save(state, os.path.join(dirname, filename or "persistables.pdparams"))


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Load what ``save_persistables`` wrote into the program's
    variables; returns the state."""
    from ..framework.io import load
    state = load(os.path.join(dirname, filename or "persistables.pdparams"))
    _program(main_program).set_state_dict(state)
    return state
