"""paddle.amp.debugging: targeted tensor numerics checks (the port of
``paddle_tpu/amp/debugging.py``): ``TensorCheckerConfig``,
``enable_tensor_checker`` / ``disable_tensor_checker``,
``check_numerics``, ``advance_step`` and ``collect_results``.

Everything rides ``FLAGS_tpu_check_nan_inf`` through
``profiler.numerics.enabled()``: one dict lookup and a bool check when
off.  Eager torch has no traced values, so a check runs when it is
called, on the host, with the configured action.

Actions:
  "warn"    — RuntimeWarning naming the site and the NaN/Inf counts
  "raise"   — NonFiniteError
  "collect" — append a finding to ``numerics.collected()`` (bounded)
"""
from __future__ import annotations

import threading
from typing import Optional

from ..profiler import numerics as _numerics

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "checker_config",
           "advance_step", "collect_results", "clear_results"]


class DebugMode:
    """reference: paddle.amp.debugging.DebugMode enum."""

    CHECK_NAN_INF_AND_ABORT = "raise"
    CHECK_NAN_INF = "warn"
    CHECK_ALL = "collect"


_VALID_ACTIONS = ("warn", "raise", "collect")


class TensorCheckerConfig:
    """Configuration of the global tensor checker.

    Args:
        enable: master switch (enable_tensor_checker also sets
            ``FLAGS_tpu_check_nan_inf`` so instrumented hot paths wake).
        debug_mode / action: "warn" | "raise" | "collect" (DebugMode
            constants map onto these).
        start_step / end_step: optional [start, end) step window; steps
            advance via `advance_step()` (hapi train_batch calls it once
            per batch; manual loops may call it themselves). Outside the
            window checks are skipped entirely.
    """

    def __init__(self, enable: bool = True,
                 debug_mode: str = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 start_step: Optional[int] = None,
                 end_step: Optional[int] = None,
                 output_dir: Optional[str] = None):
        if debug_mode not in _VALID_ACTIONS:
            raise ValueError(
                f"debug_mode must be one of {_VALID_ACTIONS} (or a "
                f"DebugMode constant), got {debug_mode!r}")
        self.enable = bool(enable)
        self.action = debug_mode
        self.start_step = start_step
        self.end_step = end_step
        self.output_dir = output_dir
        self._step = 0

    def in_window(self) -> bool:
        if self.start_step is not None and self._step < self.start_step:
            return False
        if self.end_step is not None and self._step >= self.end_step:
            return False
        return True

    def update_and_check_step(self) -> bool:
        self._step += 1
        return self.in_window()


_LOCK = threading.Lock()
_CONFIG: list = [None]


def checker_config() -> Optional[TensorCheckerConfig]:
    return _CONFIG[0]


def enable_tensor_checker(config: Optional[TensorCheckerConfig] = None):
    """Install ``config`` (default: raise-on-NaN/Inf) as the global
    tensor checker and switch ``FLAGS_tpu_check_nan_inf`` on."""
    from .. import flags as _flags

    cfg = config or TensorCheckerConfig()
    with _LOCK:
        _CONFIG[0] = cfg
        _flags._REGISTRY["FLAGS_tpu_check_nan_inf"] = bool(cfg.enable)
    return cfg


def disable_tensor_checker():
    """Uninstall the checker and switch the watchdog flag off."""
    from .. import flags as _flags

    with _LOCK:
        _CONFIG[0] = None
        _flags._REGISTRY["FLAGS_tpu_check_nan_inf"] = False


def advance_step():
    """Advance the checker's step counter (no-op without a config).
    Called once per training step by hapi train_batch so
    start_step/end_step windows track real steps."""
    cfg = _CONFIG[0]
    if cfg is not None:
        cfg.update_and_check_step()


def _default_action() -> str:
    cfg = _CONFIG[0]
    return cfg.action if cfg is not None else "warn"


def _host_check(name: str, action: str, arr):
    """The scan and the action, within the checker's step window."""
    if not _numerics.enabled():
        return
    cfg = _CONFIG[0]
    if cfg is not None and not cfg.in_window():
        return
    summary = _numerics._summarize_array(arr)
    _numerics.record_site(name, summary is not None, summary)
    if summary is not None:
        _numerics._dispatch(name, summary, action)


def check_numerics(x, name: str = "tensor", action: Optional[str] = None):
    """Scan ``x`` (a Tensor, torch tensor or array) for NaN/Inf at the
    watchdog site ``name``, and return it unchanged, so it can be
    dropped inline: ``h = check_numerics(h, "attn_out")``.  With
    ``FLAGS_tpu_check_nan_inf`` off this is a dict lookup and a bool
    check."""
    if not _numerics.enabled():
        return x
    if action is None:
        action = _default_action()
    elif action not in _VALID_ACTIONS:
        raise ValueError(
            f"action must be one of {_VALID_ACTIONS}, got {action!r}")
    arr = getattr(x, "_t", x)
    if not hasattr(arr, "dtype"):
        return x
    _host_check(name, action, arr)
    return x


def collect_results():
    """Findings recorded by action='collect' checks (oldest first)."""
    return _numerics.collected()


def clear_results():
    _numerics.clear_collected()
