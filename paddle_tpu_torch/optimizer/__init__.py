"""paddle.optimizer: the ten optimizers, ``LBFGS`` and the LR
schedulers (``lr``).  Under ``amp.decorate(level="O2")`` an optimizer
updates float32 master weights of the low-precision parameters."""
from .optimizer import (Optimizer, SGD, Momentum, Adagrad, Adam, AdamW,
                        Adamax, RMSProp, Adadelta, Lamb, LarsMomentum)
from .lbfgs import LBFGS
from . import lr
