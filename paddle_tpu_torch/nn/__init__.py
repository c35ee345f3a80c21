"""paddle.nn: ``Layer`` and its containers, the common, conv,
activation, norm, pooling, loss, RNN and transformer layers, beam-search
decoding, gradient clipping, functionals, initializers and ``utils``."""
from .layer.layers import (Layer, Parameter, Sequential, LayerList,
                           ParameterList, LayerDict)
from .layer.common import *  # noqa: F401,F403
from .layer.conv import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                         Conv2DTranspose, Conv3DTranspose)
from .layer.norm import *  # noqa: F401,F403
from .layer.activation import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import (MultiHeadAttention, TransformerEncoderLayer,
                                TransformerEncoder, TransformerDecoderLayer,
                                TransformerDecoder, Transformer)
from .decode import BeamSearchDecoder, dynamic_decode
from .clip import (ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm)
from . import functional
from . import initializer
from . import utils  # noqa: E402,F401
