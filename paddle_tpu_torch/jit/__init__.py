"""paddle.jit (the port of ``paddle_tpu/jit/``): ``to_static`` captures a
function or a Layer's forward with ``torch.export`` and replays the
captured graph; ``save`` / ``load`` write and read that graph with the
weights beside it (``api.py``); ``dy2static`` rewrites Python control
flow on tensor predicates into ``torch.cond`` / ``while_loop``.
"""
from .api import (to_static, not_to_static, ignore_module, TracedLayer,
                  TranslatedLayer, save, load, InputSpec, StaticFunction,
                  enable_to_static, set_verbosity, set_code_level)

__all__ = ["to_static", "not_to_static", "ignore_module", "save", "load",
           "InputSpec", "TracedLayer", "TranslatedLayer",
           "enable_to_static", "set_verbosity", "set_code_level"]
