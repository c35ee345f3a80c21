"""Observability of the port: the metric registry (``metrics``), the
flight recorder (``trace``) and the live HTTP exporter (``exporter``),
each gated by its flag in ``paddle_tpu_torch.flags``.  Not ported yet:
the ``Profiler`` class and its summary sections, ``xmem`` and
``numerics`` (ROADMAP A3)."""
from . import exporter, metrics, trace

__all__ = ["exporter", "metrics", "trace"]
