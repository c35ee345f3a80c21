"""paddle.optimizer: the ten optimizers and the LR schedulers (``lr``).
LBFGS comes with a later slice."""
from .optimizer import (Optimizer, SGD, Momentum, Adagrad, Adam, AdamW,
                        Adamax, RMSProp, Adadelta, Lamb, LarsMomentum)
from . import lr
