"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (sm_90a).

``import paddle_tpu_torch as paddle`` gives the eager core: ``Tensor``
over a torch tensor with torch's autograd (``core/``), the op surface
(``tensor/``, registered in ``ops.registry.OP_LIBRARY``), ``autograd``,
``nn`` (``Layer``, its common / conv / activation / norm / pooling /
loss layers, functionals, initializers, gradient clipping, ``utils``),
``optimizer`` (ten optimizers and the LR schedules), ``set_device`` /
``seed`` / ``save`` / ``load``; and the vision stack: ``vision``
(models, datasets, transforms, detection ops, image IO), ``metric``,
``hapi`` (``Model`` and its callbacks), ``geometric``; ``amp``
(``auto_cast``, ``decorate`` with master weights, ``GradScaler``,
``debugging``), ``incubate`` (fused layers, LookAhead, ModelAverage,
``asp``, the eager MoE layer), ``jit`` (``to_static`` and ``save`` /
``load`` over ``torch.export``, with the kernels as custom ops),
``distributed`` (the collective facade, ``DataParallel`` — also at the
top level, ``fleet``, ``recompute``),
``static`` (``Program`` / ``Executor``, ``enable_static``),
``_C_ops`` (the ops on raw torch tensors), ``quantization`` (QAT, PTQ,
int8 layers), ``inference`` (``Predictor`` over ``jit.save``'s artifact,
``convert_to_mixed_precision``, the C ABI's build) and ``onnx`` (which
refuses).  Tensors are created on
the current place: the card unless ``set_device`` names another; with
neither, creation raises.

Beside it, as before: ``models/`` (the Llama, GPT and ERNIE families,
functional cores with eager ``Layer`` classes, and KV-cache generation
in ``models/decoding.py``), ``ops/`` (hand-written CUDA kernels, each
beside its plain PyTorch version), ``serving/`` (the continuous-batching
engine, the multi-replica router and fleet planning), ``distributed/``
(the hybrid-parallel train step, checkpoints, the launcher), ``io/``
(samplers, the data loader, the device loader), ``profiler/`` (the
Profiler, metrics, the flight recorder, the live exporter, xmem,
numerics, the perf ledger), ``runtime/`` (the phase watchdog,
heartbeats, anomaly rewind), ``testing/`` (fault injection, the op
cases) and ``flags`` (the global flag registry).  Nothing here imports
JAX or ``paddle_tpu``; the tests hold the two packages against each
other with inputs made by numpy.
"""
from .device import resolve_device
from .core import (Tensor, to_tensor, no_grad, enable_grad,  # noqa: F401
                   is_grad_enabled, set_grad_enabled, CPUPlace, CUDAPlace)
from .core.place import (set_device, get_device, device_count,  # noqa: F401
                         is_compiled_with_cuda)
from .core.dtype import (bool_ as bool8, uint8, int8, int16,  # noqa: F401
                         int32, int64, float16, bfloat16, float32, float64,
                         complex64, complex128, set_default_dtype,
                         get_default_dtype, finfo, iinfo)
from .core.dtype import bool_ as bool  # noqa: A001,F401 — paddle.bool
from .flags import set_flags, get_flags  # noqa: F401
from .framework.random import seed, get_rng_state, set_rng_state  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401

from .tensor import *  # noqa: F401,F403 — the op surface
from .tensor import logic as _logic

grad_enabled = is_grad_enabled
is_tensor = _logic.is_tensor

from . import tensor  # noqa: E402,F401
from . import autograd  # noqa: E402,F401
from . import nn  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import framework  # noqa: E402,F401
from .framework.io import save  # noqa: E402,F401
from .framework.io import load_tensors as load  # noqa: E402,F401
from .autograd.functional import grad  # noqa: E402,F401

from . import amp  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from . import metric  # noqa: E402,F401
from . import vision  # noqa: E402,F401
from . import geometric  # noqa: E402,F401
from . import hapi  # noqa: E402,F401
from .hapi.model import Model, summary  # noqa: E402,F401

from . import models  # noqa: E402,F401
from . import distributed  # noqa: E402,F401
from .distributed.parallel import DataParallel  # noqa: E402,F401
from .models import (ErnieConfig, GPTConfig, GPTForCausalLM,  # noqa: E402,F401
                     LlamaConfig, LlamaForCausalLM)
from . import jit  # noqa: E402,F401
from . import static  # noqa: E402,F401
from . import _C_ops  # noqa: E402,F401
from . import quantization  # noqa: E402,F401
from . import inference  # noqa: E402,F401
from . import onnx  # noqa: E402,F401
from .static.program import (enable_static, disable_static,  # noqa: E402,F401
                             in_static_mode)


def in_dynamic_mode():
    """True unless a static program records (``enable_static`` or a
    ``static.program_guard``)."""
    return not in_static_mode()


in_dygraph_mode = in_dynamic_mode
