"""paddle.autograd.backward."""
from __future__ import annotations

from ..core.tensor import run_backward


def backward(tensors, grad_tensors=None, retain_graph=False):
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is not None and not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph)
