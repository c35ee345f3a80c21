"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (sm_90a).

Layout mirrors ``paddle_tpu``: ``models/llama.py`` (the functional Llama
core), ``ops/`` (hand-written CUDA kernels, each beside its plain PyTorch
version), ``serving/`` (the continuous-batching engine, the multi-replica
router and fleet planning), ``distributed/`` (the hybrid-parallel train
step, checkpoints, the launcher), ``io/`` (samplers, the data loader, the
device loader), ``profiler/`` (the Profiler, metrics, the flight
recorder, the live exporter, xmem, numerics), ``runtime/`` (the phase
watchdog, heartbeats, anomaly rewind), ``testing/`` (fault injection)
and ``flags`` (the global flag registry).  Nothing here
imports JAX or ``paddle_tpu``; the tests hold the two packages against
each other with inputs made by numpy.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
