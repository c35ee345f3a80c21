"""paddle.static long tail (the port of ``paddle_tpu/static/compat.py``):
program persistence, places, scopes, legacy executor shells, EMA.

Reference analogs: python/paddle/static/io.py (save/load/serialize_*),
fluid/executor.py scope plumbing, fluid/compiler.py (CompiledProgram /
BuildStrategy / ExecutionStrategy / ParallelExecutor), incubate EMA,
fluid/layers control Print.

As in the reference:
- Program persistence rides Program.state_dict + framework.io; the
  serialized "program" is the pickled op-free state (the graph
  re-derives from Python source; ``jit.save`` is the cross-process
  graph format).
- *_places() return the places that exist.
- CompiledProgram / ParallelExecutor / BuildStrategy /
  ExecutionStrategy are accepted-and-forwarded shells that warn once:
  the replay has no pass pipeline for their knobs to steer.
- IPU entry points raise: another vendor's accelerator.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np

__all__ = [
    "append_backward", "global_scope", "scope_guard", "Scope",
    "BuildStrategy",
    "CompiledProgram", "ExecutionStrategy", "ParallelExecutor", "Print",
    "WeightNormParamAttr", "ExponentialMovingAverage", "save", "load",
    "serialize_program", "serialize_persistables", "save_to_file",
    "deserialize_program", "deserialize_persistables", "load_from_file",
    "normalize_program", "load_program_state", "set_program_state",
    "cpu_places", "cuda_places", "xpu_places", "npu_places",
    "mlu_places", "Variable", "create_global_var", "create_parameter",
    "accuracy", "auc", "device_guard", "ipu_shard_guard",
    "IpuCompiledProgram", "IpuStrategy", "set_ipu_shard",
    "ctr_metric_bundle", "exponential_decay",
]


def _default_prog(program=None):
    if program is not None:
        return getattr(program, "_program", program)
    from .program import default_main_program
    return default_main_program()


# -- backward / scope ------------------------------------------------------

def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """reference: fluid/backward.py append_backward — registers the
    training objective on the program; the Executor computes gradients
    in-graph when it runs (minimize() without the optimizer half).
    Returns the (param, grad-placeholder) pairs."""
    from .program import recording_program
    prog = recording_program()
    if prog is None:
        raise RuntimeError("append_backward needs an active static "
                           "program (enable_static + program_guard)")
    params = parameter_list or [t for t in prog._captured()
                                if not t.stop_gradient]
    prog._opt = (None, loss)  # Executor: grads computed, no update
    return [(p, None) for p in params]


class Scope:
    """Name -> variable view over a Program (fluid Scope analog)."""

    def __init__(self, program=None):
        self._program = program

    def find_var(self, name):
        try:
            return _default_prog(self._program).var(name)
        except KeyError:
            return None

    var = find_var


_GLOBAL_SCOPE = Scope()


def global_scope():
    return _GLOBAL_SCOPE


@contextlib.contextmanager
def scope_guard(scope):
    global _GLOBAL_SCOPE
    prev, _GLOBAL_SCOPE = _GLOBAL_SCOPE, scope
    try:
        yield scope
    finally:
        _GLOBAL_SCOPE = prev


# -- legacy executor shells -------------------------------------------------

_WARNED_KNOBS = set()


def _warn_once(key, msg):
    """One warning per swallowed-knob site per process: the legacy
    shells accept configuration nothing here acts on -- silently
    dropping it hid real tuning intent (users set BuildStrategy.fuse_*
    and saw nothing)."""
    if key in _WARNED_KNOBS:
        return
    _WARNED_KNOBS.add(key)
    import warnings
    warnings.warn(msg, UserWarning, stacklevel=3)


class _AttrBag:
    def __init__(self, **kw):
        self.__dict__.update(kw)
        if kw:
            self._note_swallowed(", ".join(sorted(kw)))

    def __setattr__(self, k, v):
        self.__dict__[k] = v
        self._note_swallowed(k)

    def _note_swallowed(self, what):
        name = type(self).__name__
        _warn_once(name, f"{name}.{what} is accepted for API parity "
                   "but has no effect on this stack: the Executor replays "
                   "the recorded ops, with no pass pipeline to steer")


class BuildStrategy(_AttrBag):
    """Accepted for parity; the replay has no passes for the legacy
    flags to steer."""


class ExecutionStrategy(_AttrBag):
    """Accepted for parity; the replaying Executor has no thread-pool
    knobs to set."""


class CompiledProgram:
    """reference: compiler.py CompiledProgram -- here a transparent
    proxy of the program."""

    def __init__(self, program, build_strategy=None):
        self._program = _default_prog(program)
        self._build_strategy = build_strategy
        if build_strategy is not None:
            _warn_once("CompiledProgram.build_strategy",
                       "CompiledProgram ignores build_strategy: the "
                       "Executor replays the recorded ops as they are")

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        _warn_once("CompiledProgram.with_data_parallel",
                   "with_data_parallel is a no-op on this stack: "
                   "data parallelism comes from the 'dp' axis of "
                   "paddle.distributed's Plan, not executor replicas")
        return self

    def __getattr__(self, name):
        return getattr(self.__dict__["_program"], name)


class ParallelExecutor:
    """Legacy pre-2.0 API: delegates to the modern Executor (the
    reference itself deprecates it toward CompiledProgram)."""

    def __init__(self, use_cuda=False, loss_name=None,
                 main_program=None, **kw):
        from . import Executor
        if kw:
            _warn_once("ParallelExecutor.kwargs",
                       f"ParallelExecutor ignores {sorted(kw)}: it "
                       "delegates to the modern Executor (one device)")
        self._exe = Executor()
        self._prog = _default_prog(main_program)

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._prog, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """reference: layers/control_flow Print op -- prints the tensor when
    the op runs (at the build and at every replay) and passes the value
    through."""
    from ..core.tensor import apply_op

    def _f(a):
        print((message or "Print") + ":", a)
        return a
    return apply_op(_f, input, op_name="print")


# -- persistence ------------------------------------------------------------

def _state_np(program):
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in _default_prog(program).state_dict().items()}


def serialize_program(feed_vars=None, fetch_vars=None, program=None):
    prog = _default_prog(program)
    meta = {"feeds": sorted(prog._feeds), "n_ops": len(prog._ops),
            "note": "graph re-derives from python; state is the "
                    "persisted half (jit.save exports the graph)"}
    return pickle.dumps(meta)


def serialize_persistables(feed_vars=None, fetch_vars=None, program=None):
    return pickle.dumps(_state_np(program))


def save_to_file(path, content):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    state = pickle.loads(data)
    _default_prog(program).set_state_dict(state)
    return state


def save(program, model_path, protocol=4, **configs):
    """reference: static.save — <prefix>.pdparams + .pdmodel pair."""
    save_to_file(model_path + ".pdparams",
                 pickle.dumps(_state_np(program), protocol=protocol))
    save_to_file(model_path + ".pdmodel", serialize_program(
        program=program))


def load(program, model_path, executor=None, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        state = pickle.load(f)
    _default_prog(program).set_state_dict(state)
    return state


def load_program_state(model_path, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)


def set_program_state(program, state_dict):
    _default_prog(program).set_state_dict(state_dict)


def normalize_program(program, feed_vars=None, fetch_vars=None):
    """The inference-normalization pass (prune feeds/backward) maps to
    clone(for_test=True) on this stack."""
    return _default_prog(program).clone(for_test=True)


# -- places / variables -----------------------------------------------------

def cpu_places(device_count=None):
    from ..core.place import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def _accel_places(kind, device_ids=None):
    from ..core.place import CUDAPlace
    if kind != "cuda":
        import warnings
        warnings.warn(f"{kind}_places on a CUDA build: returning the "
                      "available CUDA places")
    ids = device_ids if device_ids is not None else [0]
    return [CUDAPlace(i) for i in ids]


def cuda_places(device_ids=None):
    return _accel_places("cuda", device_ids)


def xpu_places(device_ids=None):
    return _accel_places("xpu", device_ids)


def npu_places(device_ids=None):
    return _accel_places("npu", device_ids)


def mlu_places(device_ids=None):
    return _accel_places("mlu", device_ids)


def _variable():
    from ..core.tensor import Tensor
    return Tensor


Variable = None  # bound below (import-order: Tensor needs core ready)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    import torch

    from ..core.dtype import convert_dtype
    from ..core.place import current_device
    from ..core.tensor import Tensor
    t = Tensor(torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                          device=("cpu" if force_cpu
                                  else current_device())))
    t.name = name
    t.stop_gradient = True
    return t


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    import torch

    from ..core.dtype import convert_dtype
    from ..core.place import current_device
    from ..nn.layer.layers import Parameter
    if default_initializer is not None:
        from ..nn.layer.layers import Layer
        helper = Layer()
        return helper.create_parameter(list(shape), attr=attr,
                                       is_bias=is_bias,
                                       default_initializer=default_initializer)
    dev = current_device()
    dt = convert_dtype(dtype)
    if is_bias:
        arr = torch.zeros(tuple(shape), dtype=dt, device=dev)
    else:
        # drawn from the framework's generator (paddle.seed sets it, each
        # call advances it), N(0, 0.02^2) as the reference's
        from ..framework.random import generator_for
        arr = (torch.randn(tuple(shape), generator=generator_for(dev),
                           device=dev) * 0.02).to(dt)
    return Parameter(arr, trainable=True, name=name or "")


# -- metrics / misc ---------------------------------------------------------

def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    import torch

    from ..core.tensor import apply_op

    def _f(lg, y):
        topk = torch.argsort(-lg, dim=-1, stable=True)[..., :k]
        hit = (topk == y.reshape(-1, 1)).any(-1)
        return torch.mean(hit.float())
    return apply_op(_f, input, label, op_name="accuracy")


def auc(input, label, curve="ROC", num_thresholds=4095,  # noqa: A002
        topk=1, slide_steps=1):
    import torch

    from ..core.tensor import apply_op

    def _f(p, y):
        # rank-statistic AUC (Mann-Whitney U); p: positive-class score
        score = p[..., 1] if p.dim() > 1 and p.shape[-1] == 2 else \
            p.reshape(-1)
        y = y.reshape(-1).to(score.dtype)
        order = torch.argsort(score, stable=True)
        ranks = torch.zeros_like(score).scatter(
            0, order, torch.arange(1, score.shape[0] + 1, dtype=score.dtype,
                                   device=score.device))
        n_pos = torch.sum(y)
        n_neg = y.shape[0] - n_pos
        u = torch.sum(ranks * y) - n_pos * (n_pos + 1) / 2
        return u / torch.clamp(n_pos * n_neg, min=1.0)
    return apply_op(_f, input, label, op_name="auc")


def ctr_metric_bundle(input, label, ins_tag_weight=None):  # noqa: A002
    """reference: static/nn/metric ctr_metric_bundle — (auc, batch_auc)
    pair for CTR models; one pool on a single-job build."""
    a = auc(input, label)
    return a, a


@contextlib.contextmanager
def device_guard(device=None):
    """reference: device_guard('cpu'/'gpu') op placement hint; ops run on
    their inputs' device, so the guard is accepted and ignored."""
    yield


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """reference: fluid layers exponential_decay —
    lr(step) = learning_rate * decay_rate ** (step / decay_steps),
    with the exponent floored when staircase. Returns the modern
    scheduler: StepDecay IS the staircase form; the smooth form maps
    onto ExponentialDecay through the per-step gamma
    decay_rate ** (1 / decay_steps)."""
    if decay_steps <= 0:
        raise ValueError(
            f"decay_steps must be a positive integer, got {decay_steps}")
    if staircase:
        from ..optimizer.lr import StepDecay
        return StepDecay(learning_rate=learning_rate,
                         step_size=int(decay_steps), gamma=decay_rate)
    from ..optimizer.lr import ExponentialDecay
    return ExponentialDecay(learning_rate=learning_rate,
                            gamma=decay_rate ** (1.0 / decay_steps))


class WeightNormParamAttr:
    """reference: fluid/param_attr.py WeightNormParamAttr — carries the
    weight-norm dim; apply weight norm with nn.utils.weight_norm on
    this stack (the ParamAttr route needs the legacy op rewriter)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


class ExponentialMovingAverage:
    """reference: incubate ExponentialMovingAverage over program
    parameters: shadow = decay * shadow + (1 - decay) * param, with
    apply()/restore() swaps."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._shadow = {}
        self._backup = {}

    def update(self, parameters=None):
        params = parameters
        if params is None:
            from .program import recording_program
            prog = recording_program() or _default_prog()
            params = [t for t in prog._captured() if not t.stop_gradient]
        for i, p in enumerate(params):
            key = getattr(p, "name", None) or f"p{i}"
            cur = p.numpy() if hasattr(p, "numpy") else np.asarray(p)
            prev = self._shadow.get(key)
            self._shadow[key] = cur.copy() if prev is None else \
                self._decay * prev + (1 - self._decay) * cur
            self._shadow.setdefault("__obj__" + key, p)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        import torch
        for key, val in list(self._shadow.items()):
            if key.startswith("__obj__"):
                continue
            p = self._shadow["__obj__" + key]
            self._backup[key] = p._t.detach().clone()
            p._set_array(torch.as_tensor(val, dtype=p._t.dtype,
                                         device=p._t.device))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        for key, arr in self._backup.items():
            self._shadow["__obj__" + key]._set_array(arr)
        self._backup.clear()


# -- IPU: out of scope -------------------------------------------------------

_IPU_MSG = ("IPU support is out of scope for a CUDA build "
            "(reference gates these behind is_compiled_with_ipu(), "
            "False here); use the ordinary jit/static path")


def ipu_shard_guard(index=-1, stage=-1):
    raise NotImplementedError(_IPU_MSG)


def set_ipu_shard(call_func, index=-1, stage=-1):
    raise NotImplementedError(_IPU_MSG)


class IpuStrategy:
    def __init__(self):
        raise NotImplementedError(_IPU_MSG)


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError(_IPU_MSG)


def _late_bind():
    global Variable
    from ..core.tensor import Tensor
    Variable = Tensor


_late_bind()
