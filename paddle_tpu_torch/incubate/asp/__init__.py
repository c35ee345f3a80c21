"""Automatic SParsity, 2:4 structured (the port of
``paddle_tpu/incubate/asp/``; reference:
python/paddle/incubate/asp/__init__.py)."""
from .utils import (  # noqa: F401
    calculate_density, get_mask_1d, check_mask_1d, get_mask_2d_greedy,
    get_mask_2d_best, check_mask_2d, create_mask, check_sparsity,
    MaskAlgo, CheckMethod)
from .asp import (  # noqa: F401
    prune_model, decorate, set_excluded_layers, reset_excluded_layers,
    ASPHelper)

__all__ = [
    "calculate_density", "get_mask_1d", "check_mask_1d",
    "get_mask_2d_greedy", "get_mask_2d_best", "check_mask_2d",
    "create_mask", "check_sparsity", "MaskAlgo", "CheckMethod",
    "prune_model", "decorate", "set_excluded_layers",
    "reset_excluded_layers", "ASPHelper",
]
