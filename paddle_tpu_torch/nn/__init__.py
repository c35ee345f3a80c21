"""paddle.nn: the ported part (``Layer`` and its containers, the common,
activation, norm and loss layers, gradient clipping, functionals and
initializers).  conv, pooling, rnn, transformer and decode come with a
later slice."""
from .layer.layers import (Layer, Parameter, Sequential, LayerList,
                           ParameterList, LayerDict)
from .layer.common import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.activation import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .clip import (ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm)
from . import functional
from . import initializer
