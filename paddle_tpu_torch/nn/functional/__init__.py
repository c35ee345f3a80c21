"""paddle.nn.functional: activations, common, conv, pooling, norms,
losses, vision and the extended ops; ``sparse_attention`` is
``incubate``'s."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403
from .extended import *  # noqa: F401,F403
from ...tensor.manipulation import pad  # noqa: F401

# in-place activation variants ride the shared tensor in-place machinery;
# diag_embed lives on the tensor surface
from ...tensor.extras import _inplace as _mk_inplace  # noqa: E402
from .activation import elu, softmax, tanh  # noqa: E402

elu_ = _mk_inplace(elu)
softmax_ = _mk_inplace(softmax)
tanh_ = _mk_inplace(tanh)

from ...tensor.creation import diag_embed  # noqa: E402,F401
from ...incubate.nn.functional import sparse_attention  # noqa: E402,F401
