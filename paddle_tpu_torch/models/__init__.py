"""Model code of the port: ``llama`` (the serving core) and ``convert``
(weights from ``paddle_tpu``'s parameter tree)."""
