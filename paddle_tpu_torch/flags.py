"""Global flag registry: the port's copy of ``paddle_tpu/core/flags.py``
with the flags its observability and runtime modules read.

Flags are plain Python values.  Each is initialised from the
environment variable of the same name when it is set, else from its
default; ``set_flags`` changes them at run time.  The disabled paths of
``profiler.metrics``, ``profiler.trace`` and ``profiler.exporter`` read
``_REGISTRY`` directly: one dict lookup and a bool check.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    """Register a flag.  The environment variable of the same name
    overrides the default."""
    val = default
    env = os.environ.get(name)
    if env is not None:
        if isinstance(default, bool):
            val = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            val = int(env)
        elif isinstance(default, float):
            val = float(env)
        else:
            val = env
    _REGISTRY[name] = val
    return val


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"Unknown flag {k!r}; registered: "
                           f"{sorted(_REGISTRY)}")
        _REGISTRY[k] = v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[k] for k in flags}


def flag(name: str):
    return _REGISTRY[name]


define_flag("FLAGS_tpu_metrics", False,
            "Enable the profiler.metrics registry (the serving engine's "
            "and router's serve_* counters, gauges and histograms). Off: "
            "every recording call is a dict lookup + bool check.")
define_flag("FLAGS_tpu_metrics_port", 0,
            "Serve live observability over HTTP (profiler.exporter): "
            "/metrics (Prometheus text), /healthz, /slo, /incidents, "
            "/trace/tail. 0 disables (the check is one dict lookup); "
            "-1 binds an ephemeral port; >0 binds that port, falling "
            "back to an ephemeral one if it is taken.")
define_flag("FLAGS_tpu_watchdog", False,
            "Arm the process-wide phase watchdog (runtime.watchdog) at "
            "the framework's phase sites: the serving engine's "
            "serve.step. Off: the site checks one flag.")
define_flag("FLAGS_tpu_watchdog_serve_step", 120.0,
            "Deadline (s) for one serving engine step (serve.step "
            "watchdog phase). A step past the deadline is treated as a "
            "hang and recovered by the engine's pool-rebuild replay. "
            "<=0 disables.")
define_flag("FLAGS_tpu_watchdog_collective", 120.0,
            "Deadline (s) a rank may spend inside one collective before "
            "the health monitor declares a CollectiveTimeout and "
            "converts it to an exit-101 relaunch. <=0 disables.")
define_flag("FLAGS_tpu_watchdog_ckpt_commit", 300.0,
            "Deadline (s) for the ckpt.commit watchdog phase (the "
            "atomic checkpoint rename + fsync protocol). <=0 disables.")
define_flag("FLAGS_tpu_trace", False,
            "Structured event/span tracing (profiler.trace flight "
            "recorder): ring-buffered request-lifecycle, engine-step "
            "and router events with JSONL sidecars for "
            "tools/trace_report.py. Off: every recording call is a dict "
            "lookup + bool check.")
define_flag("FLAGS_tpu_fused_blocks", "auto",
            "Fused decoder-block kernels (ops.fused_blocks."
            "fused_attention_block / fused_mlp_block): 'auto' uses them "
            "on CUDA tensors for qualifying shapes and never on the CPU, "
            "'on' forces the fused path wherever the blocks can run (the "
            "CPU runs their plain versions, what parity tests use), "
            "'off' keeps the unfused composition everywhere. "
            "LlamaConfig.fused_blocks overrides per-model; this flag is "
            "the default for configs that leave it None.")
define_flag("FLAGS_tpu_quantized", "auto",
            "int8 weight path for serving (ops.int8_matmul behind "
            "models.llama quantize_params): 'auto' quantizes the weights "
            "on CUDA only (the CPU keeps dense weights), 'on' forces the "
            "quantized weight path everywhere incl. the CPU (the plain "
            "int8 version: same math), 'off' keeps dense weights. "
            "LlamaConfig.quantized overrides per-model; this flag is the "
            "default for configs that leave it None. The quantized KV "
            "cache is a separate knob (LLMEngine kv_dtype / bench_serve "
            "--kv-dtype).")
