"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (sm_90a).

Layout mirrors ``paddle_tpu``: ``models/llama.py`` (the functional Llama
core), ``ops/`` (hand-written CUDA kernels, each beside its plain PyTorch
version), ``serving/`` (the continuous-batching engine, the multi-replica
router and fleet planning), ``profiler/`` (metrics, the flight recorder,
the live exporter), ``runtime/`` (the phase watchdog, heartbeats),
``testing/`` (fault injection) and ``flags`` (the global flag registry).  Nothing here
imports JAX or ``paddle_tpu``; the tests hold the two packages against
each other with inputs made by numpy.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
