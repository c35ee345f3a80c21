"""paddle.vision: the model zoo, datasets, transforms, detection ops and
image IO (the port of ``paddle_tpu/vision``)."""
from . import models
from . import transforms
from . import datasets
from . import ops
from . import io
