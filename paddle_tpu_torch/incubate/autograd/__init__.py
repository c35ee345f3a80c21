"""paddle.incubate.autograd (the port of
``paddle_tpu/incubate/autograd/``): the functional jacobian / hessian /
vjp / jvp of ``autograd.functional``, and the prim toggles, which
change nothing here (torch's autograd has no prim mode)."""
from ...autograd.functional import jacobian, hessian, vjp, jvp  # noqa: F401

_PRIM_ENABLED = [False]


def enable_prim():
    _PRIM_ENABLED[0] = True


def disable_prim():
    _PRIM_ENABLED[0] = False


def prim_enabled():
    return _PRIM_ENABLED[0]
