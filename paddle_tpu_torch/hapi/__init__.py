"""paddle.hapi: ``Model``, ``summary`` and the callbacks (the port of
``paddle_tpu/hapi``)."""
from .model import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
