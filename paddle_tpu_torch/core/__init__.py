"""The eager core's base: dtypes, places, errors and the ``Tensor``
facade over a torch tensor (the port of ``paddle_tpu/core``)."""
from .tensor import (Tensor, to_tensor, apply_op, no_grad, enable_grad,
                     is_grad_enabled, set_grad_enabled)
from .place import CPUPlace, CUDAPlace, Place, set_device, get_device

__all__ = ["Tensor", "to_tensor", "apply_op", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled", "Place", "CPUPlace",
           "CUDAPlace", "set_device", "get_device"]
