"""Static graph core: Program recording + Executor replay (the port of
``paddle_tpu/static/program.py``; reference analog: the ProgramDesc
build + Executor run split, python/paddle/fluid/framework.py Program /
Block and fluid/executor.py:1387 Executor.run over a feed/fetch
contract).

"Append an OpDesc" = record the torch callable that ``apply_op``
(core/tensor.py) routes every framework op through, with its input and
output ``Tensor`` identities: the op list is the program.  While a
program records, each op runs once on the build's values (placeholder
zeros from ``static.data``: shape inference for free) without a graph,
and is appended.  ``Executor.run`` replays the list on the fed arrays
and the parameters' live tensors: parameters enter by identity, so
optimizer updates between runs are seen; under ``minimize`` the replay
runs under autograd, ``backward()`` of the loss fills the parameters'
``.grad`` exactly as an eager step does, and the optimizer steps
eagerly.  The recorded callables are shape-generic torch code, so a run
may feed any batch size.  Layer state that changes during the forward
(batch norm's running statistics) is recorded as state writes
(``record_state_write``): the replay computes the new values and the
Executor writes them into the live buffers after each run.
``clone(for_test=True)`` drops the optimizer and the state writes.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import tensor as tensor_mod
from ..core.tensor import Tensor

__all__ = ["Program", "Executor", "program_guard", "default_main_program",
           "default_startup_program", "enable_static", "disable_static",
           "in_static_mode", "data", "record_state_write",
           "recording_program"]


class _OpRecord:
    __slots__ = ("pure_fn", "inputs", "outputs", "op_name")

    def __init__(self, pure_fn, inputs, outputs, op_name):
        self.pure_fn = pure_fn
        self.inputs = list(inputs)    # Tensor refs
        self.outputs = list(outputs)  # Tensor refs
        self.op_name = op_name


class Program:
    """An op list and a feed registry, recorded while the program is
    active."""

    def __init__(self):
        self._ops: List[_OpRecord] = []
        self._feeds: Dict[str, Tensor] = {}
        self._opt = None          # (optimizer, loss Tensor) from minimize
        # (live tensor, graph value) pairs the replay persists after
        # each run (batch norm's running statistics)
        self._state_writes: List[tuple] = []
        # id(live state tensor) -> its latest graph value: later reads
        # chain onto the pending update (a norm layer applied twice)
        self._state_alias: Dict[int, Tensor] = {}

    # -- build side ---------------------------------------------------------
    def _record(self, pure_fn, inputs, outputs, op_name):
        if self._state_alias:
            inputs = [self._state_alias.get(id(t), t) for t in inputs]
        self._ops.append(_OpRecord(pure_fn, inputs, outputs, op_name))

    def _add_feed(self, name: str, t: Tensor):
        if name in self._feeds:
            raise ValueError(f"duplicate feed var name {name!r}")
        self._feeds[name] = t

    def clone(self, for_test=False):
        """Share the recorded graph; a for_test clone drops the
        optimizer and the state writes (reference:
        Program.clone(for_test=True)).  Ops replay in their build-time
        mode: rebuild under ``layer.eval()`` for inference-mode layers."""
        p = Program()
        p._ops = self._ops
        p._feeds = self._feeds
        p._opt = None if for_test else self._opt
        p._state_writes = [] if for_test else self._state_writes
        return p

    def global_block(self):
        return self

    # -- persistence (reference: Program.state_dict / save_persistables)
    def state_dict(self, mode="all"):
        """The captured (parameter / constant) tensors by name."""
        out = {}
        for i, t in enumerate(self._captured()):
            out[getattr(t, "name", None) or f"cap_{i}"] = t
        return out

    def set_state_dict(self, state_dict):
        caps = self._captured()
        by_name = {getattr(t, "name", None) or f"cap_{i}": t
                   for i, t in enumerate(caps)}
        missing = []
        for k, v in state_dict.items():
            t = by_name.get(k)
            if t is None:
                missing.append(k)
                continue
            arr = v._t if isinstance(v, Tensor) else torch.as_tensor(
                np.asarray(v))
            t._set_array(arr.to(device=t._t.device, dtype=t._t.dtype))
        if missing:
            import warnings
            warnings.warn(f"set_state_dict: no program vars named "
                          f"{missing[:5]}{'...' if len(missing) > 5 else ''}")

    def var(self, name: str) -> Tensor:
        if name in self._feeds:
            return self._feeds[name]
        for rec in self._ops:
            for t in rec.outputs:
                if getattr(t, "name", None) == name:
                    return t
        raise KeyError(f"no var named {name!r} in program")

    def list_vars(self):
        seen, out = set(), []
        for t in self._feeds.values():
            seen.add(id(t))
            out.append(t)
        for rec in self._ops:
            for t in rec.outputs:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    # -- run-side helpers ---------------------------------------------------
    def _captured(self) -> List[Tensor]:
        """Inputs that are neither feeds nor op outputs: parameters and
        build-time constants, whose live tensors the replay reads."""
        produced = {id(t) for rec in self._ops for t in rec.outputs}
        feed_ids = {id(t) for t in self._feeds.values()}
        seen, caps = set(), []
        for rec in self._ops:
            for t in rec.inputs:
                tid = id(t)
                if tid in produced or tid in feed_ids or tid in seen:
                    continue
                seen.add(tid)
                caps.append(t)
        return caps

    def _replay(self, env: Dict[int, torch.Tensor]):
        """env: tensor id -> torch tensor for the feeds and the captured
        tensors; fills in every op's outputs."""
        for rec in self._ops:
            out = rec.pure_fn(*[env[id(t)] for t in rec.inputs])
            outs = out if isinstance(out, (tuple, list)) else [out]
            for t, o in zip(rec.outputs, outs):
                env[id(t)] = o
        return env


# --------------------------------------------------------------------------
# active-program state (build-time recording)
# --------------------------------------------------------------------------

class _StaticState(threading.local):
    def __init__(self):
        self.enabled = False
        self.program_stack: List[Program] = []


_state = _StaticState()
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def recording_program() -> Optional[Program]:
    if _state.program_stack:
        return _state.program_stack[-1]
    if _state.enabled:
        return _main_program
    return None


def enable_static():
    """paddle.enable_static: API calls now append ops to the default
    main program."""
    _state.enabled = True
    tensor_mod._STATIC_RECORD_HOOK[0] = _record_hook


def disable_static():
    _state.enabled = False
    if not _state.program_stack:
        tensor_mod._STATIC_RECORD_HOOK[0] = None


def in_static_mode() -> bool:
    return recording_program() is not None


def _record_hook(fn, inputs, kwargs, op_name):
    """``apply_op`` while a program records: run the op on the build's
    values without a graph, wrap it and append it."""
    prog = recording_program()
    if prog is None:
        return tensor_mod.wrap_outputs(
            fn(*[tensor_mod._unwrap(x) for x in inputs], **kwargs), op_name)
    tensor_idx = [i for i, x in enumerate(inputs) if isinstance(x, Tensor)]
    const = list(inputs)

    def pure_fn(*ts):
        full = list(const)
        for slot, t in zip(tensor_idx, ts):
            full[slot] = t
        return fn(*[tensor_mod._unwrap(x) for x in full], **kwargs)

    with torch.no_grad():
        out = pure_fn(*[inputs[i]._t for i in tensor_idx])
    res = tensor_mod.wrap_outputs(out, op_name)
    outs = list(res) if isinstance(res, tuple) else [res]
    prog._record(pure_fn, [inputs[i] for i in tensor_idx], outs, op_name)
    return res


def record_state_write(dst: Tensor, src: Tensor):
    """Layers call this when they change persistent state during the
    build (batch norm's running statistics): the Executor recomputes
    ``src`` each run and writes it into the live ``dst``.  Later
    recorded reads of ``dst`` resolve to ``src``."""
    prog = recording_program()
    if prog is not None:
        prog._state_writes.append((dst, src))
        prog._state_alias[id(dst)] = src


class program_guard:
    """Scope recording to the given programs (reference:
    paddle.static.program_guard)."""

    def __init__(self, main_program: Program, startup_program=None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._prev = (_main_program, _startup_program)
        _main_program = self._main
        if self._startup is not None:
            _startup_program = self._startup
        _state.program_stack.append(self._main)
        tensor_mod._STATIC_RECORD_HOOK[0] = _record_hook
        return self._main

    def __exit__(self, *exc):
        global _main_program, _startup_program
        _main_program, _startup_program = self._prev
        _state.program_stack.pop()
        if not _state.program_stack and not _state.enabled:
            tensor_mod._STATIC_RECORD_HOOK[0] = None
        return False


def data(name: str, shape, dtype="float32", lod_level=0) -> Tensor:
    """A feed placeholder: a named Tensor whose build value is zeros on
    the current place (None / -1 dimensions as 1); Executor.run puts the
    fed batch in its place."""
    from ..core.dtype import convert_dtype
    from ..core.place import current_device
    concrete = [1 if (d is None or int(d) < 0) else int(d) for d in shape]
    t = Tensor(torch.zeros(concrete, dtype=convert_dtype(dtype),
                           device=current_device()), stop_gradient=True)
    t.name = name
    # the spec with its dynamic dimensions (None), for
    # save_inference_model's meta
    t._data_spec = [None if (d is None or int(d) < 0) else int(d)
                    for d in shape]
    prog = recording_program()
    if prog is None:
        raise RuntimeError(
            "static.data requires an active program: call "
            "paddle.enable_static() or use static.program_guard")
    prog._add_feed(name, t)
    return t


# --------------------------------------------------------------------------
# Executor
# --------------------------------------------------------------------------

def _feed_tensor(v, like: Tensor) -> torch.Tensor:
    t = v._t if isinstance(v, Tensor) else v
    if not torch.is_tensor(t):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=like._t.device, dtype=like._t.dtype)


class Executor:
    """Runs recorded programs (the InterpreterCore analog): the op list
    replayed on the feeds and the parameters' live tensors."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        if callable(program) and not isinstance(program, Program):
            # legacy convenience: run a static function directly
            args = [v for v in (feed or {}).values()]
            out = program(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return [o.numpy() if isinstance(o, Tensor) else o
                    for o in outs] if return_numpy else list(outs)
        program = program if program is not None else _main_program
        program = getattr(program, "_program", program)
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if not program._ops and not fetch_list:
            return []  # the startup program: parameters exist already
        feeds = sorted(program._feeds.items())
        missing = [n for n, _ in feeds if n not in feed]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        env = {id(t): _feed_tensor(feed[n], t) for n, t in feeds}
        caps = program._captured()
        env.update({id(t): t._t for t in caps})
        train = program._opt is not None
        state_srcs = [src for _dst, src in program._state_writes]
        if train:
            opt, loss_t = program._opt
            with torch.enable_grad():
                program._replay(env)
                loss = env[id(loss_t)]
                if loss.dim():
                    loss = loss.float().sum()
                Tensor._wrap(loss).backward()
            if opt is not None:
                if not opt._parameter_list:
                    # minimize() during the build could not know the
                    # program's trainables: bind them now, in capture
                    # (op) order
                    opt._parameter_list = [t for t in caps
                                           if not t.stop_gradient]
                opt.step()
                opt.clear_grad()
        else:
            with torch.no_grad():
                program._replay(env)
        fetch_vals = [env[id(t)].detach() for t in fetch_list]
        for (dst, _src), src in zip(program._state_writes, state_srcs):
            dst._set_array(env[id(src)].detach())
        if return_numpy:
            return [Tensor._wrap(v).numpy() for v in fetch_vals]
        return [Tensor._wrap(v) for v in fetch_vals]
