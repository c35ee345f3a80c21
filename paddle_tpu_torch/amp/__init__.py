"""paddle.amp: ``debugging`` (the tensor checker).  ``auto_cast``,
``decorate`` and ``GradScaler`` come with a later slice."""
from . import debugging  # noqa: F401
