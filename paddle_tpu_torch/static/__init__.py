"""paddle.static (the port of ``paddle_tpu/static/``): the static-graph
user surface.

Reference analog: python/paddle/static/ -- Program / Executor /
program_guard / data over ProgramDesc + the StandaloneExecutor.  Here
the build side records every op the API applies (``program.py``: the op
list is the ProgramDesc, its replay on the feeds is the interpreter),
so the classic workflow works end to end:

    paddle.enable_static()
    x = static.data("x", [None, 8])
    y = static.data("y", [None, 1])
    loss = paddle.mean((static.nn.fc(x, 1) - y) ** 2)
    paddle.optimizer.SGD(0.01).minimize(loss)
    exe = static.Executor()
    exe.run(static.default_startup_program())
    loss_val, = exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])

Control flow (static.nn.cond / while_loop / ...) lowers to torch's
higher-order ops under a capture (``control_flow.py``).
"""
from __future__ import annotations

import contextlib

import torch

from ..jit.api import InputSpec, StaticFunction, to_static  # noqa: F401
from .program import (Program, Executor, program_guard,  # noqa: F401
                      default_main_program, default_startup_program,
                      enable_static, disable_static, in_static_mode, data)
from .compat import *  # noqa: F401,F403 -- persistence, places, shells
from .compat import __all__ as _compat_all

__all__ = ["InputSpec", "Program", "program_guard", "default_main_program",
           "default_startup_program", "Executor", "data", "name_scope",
           "py_func", "save_inference_model", "load_inference_model",
           "gradients", "enable_static", "disable_static",
           "in_static_mode"] + list(_compat_all)


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def py_func(func, x, out, backward_func=None):
    raise NotImplementedError("py_func: use eager mode / PyLayer instead")


class _Slice(torch.nn.Module):
    """A program's feed -> fetch slice as a function of (state, *feeds):
    the recorded ops replayed with the captured tensors as inputs."""

    def __init__(self, program, feed_vars, fetch_vars, caps):
        super().__init__()
        self._p, self._feeds, self._fetch, self._caps = (
            program, feed_vars, fetch_vars, caps)

    def forward(self, state, *feeds):
        env = {id(t): a for t, a in zip(self._feeds, feeds)}
        env.update({id(t): a for t, a in zip(self._caps, state)})
        self._p._replay(env)
        outs = [env[id(t)] for t in self._fetch]
        return outs[0] if len(outs) == 1 else tuple(outs)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Export a Program's feed -> fetch slice as ``jit.save``'s artifact
    (reference: static/io.py save_inference_model prunes the ProgramDesc
    to the feed/fetch subgraph; here the replay is the slice).  Loadable
    by load_inference_model / jit.load.  Placeholders declared with
    dynamic dimensions (``static.data('x', [None, 8])``) export with
    those dimensions dynamic (``torch.export.Dim``, one a dynamic axis
    position, shared by every feed as the reference's symbols are), so
    the artifact serves any batch size; when the ops cannot be captured
    symbolically the export falls back to the build shapes with a
    warning."""
    import warnings

    from ..jit.api import _write
    program = program if program is not None else default_main_program()
    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    caps = program._captured()
    state = [t._t for t in caps]
    module = _Slice(program, feed_vars, fetch_vars, caps)
    specs = [getattr(t, "_data_spec", None) or list(t.shape)
             for t in feed_vars]
    axes = sorted({i for s in specs for i, d in enumerate(s) if d is None})
    # the build placeholders hold 1 at a dynamic axis, which export
    # would specialise on: trace at 2 there
    feeds = [torch.zeros([2 if d is None else d for d in s],
                         dtype=t._t.dtype, device=t._t.device)
             for s, t in zip(specs, feed_vars)]
    syms = {i: torch.export.Dim(f"_ax{i}") for i in axes}
    dyn = ({"state": tuple(None for _ in state),
            "feeds": tuple({i: syms[i] for i, d in enumerate(s)
                            if d is None} or None for s in specs)}
           if axes else None)
    polymorphic = bool(axes)
    try:
        with torch.no_grad():
            ep = torch.export.export(module, (tuple(state), *feeds),
                                     dynamic_shapes=dyn, strict=False)
    except Exception as e:
        if not axes:
            raise
        warnings.warn(
            "save_inference_model: the shape-polymorphic export of the "
            f"dynamic dims failed ({e}); exporting with the build shapes "
            "(dynamic dims as 1): the artifact will only accept that shape "
            "at serving time.", RuntimeWarning, stacklevel=2)
        polymorphic = False
        feeds = [t._t for t in feed_vars]
        with torch.no_grad():
            ep = torch.export.export(module, (tuple(state), *feeds),
                                     strict=False)
    in_specs = [InputSpec(s if polymorphic else list(t.shape), t.dtype)
                for s, t in zip(specs, feed_vars)]
    _write(path_prefix, ep, [f"__cap_{i}" for i in range(len(caps))],
           state, in_specs)
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    from ..jit import load as jload
    return jload(path_prefix)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: static.gradients -- the gradients of ``targets`` with
    respect to ``inputs`` through autograd (eager tensors; a recording
    program's build keeps no graph, ROADMAP C)."""
    from ..autograd.functional import grad
    return grad(targets, inputs, grad_outputs=target_gradients,
                allow_unused=True)


from . import nn  # noqa: E402,F401
from ..amp import auto_cast as amp  # noqa: E402,F401
