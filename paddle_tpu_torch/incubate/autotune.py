"""paddle.incubate.autotune: the switch of the kernels' tile search.

The reference's switch gates its measured block-size selection for the
Pallas kernels (``paddle_tpu/ops/autotune.py``).  The port's tile search
over its CUDA kernels comes with ROADMAP A item 8 (analysis and
autotune); until then every entry point raises and names that item.
"""

__all__ = ["set_config", "enabled", "save", "load", "cache_stats"]

_ITEM8 = ("the port's kernel tile search comes with ROADMAP A item 8 "
          "(analysis and autotune)")


def set_config(config=None):
    raise NotImplementedError(f"incubate.autotune.set_config: {_ITEM8}")


def enabled():
    raise NotImplementedError(f"incubate.autotune.enabled: {_ITEM8}")


def save(path):
    raise NotImplementedError(f"incubate.autotune.save: {_ITEM8}")


def load(path):
    raise NotImplementedError(f"incubate.autotune.load: {_ITEM8}")


def cache_stats():
    raise NotImplementedError(f"incubate.autotune.cache_stats: {_ITEM8}")
