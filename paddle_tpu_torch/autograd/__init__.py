"""paddle.autograd over torch's engine (the port of
``paddle_tpu/autograd``)."""
from .functional import grad, vjp, jvp, jacobian, hessian
from .pylayer import PyLayer, PyLayerContext, saved_tensors_hooks
from .backward_mode import backward
from ..core.tensor import no_grad, enable_grad, set_grad_enabled, \
    is_grad_enabled

__all__ = ["grad", "vjp", "jvp", "jacobian", "hessian", "PyLayer",
           "PyLayerContext", "backward", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "saved_tensors_hooks"]
