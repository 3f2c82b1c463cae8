"""Assigned-architecture configs and the shape grid (data only)."""
from repro_torch.configs.registry import (
    ARCHS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ShapeSpec,
    cell_is_skipped,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCHS",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "ShapeSpec",
    "cell_is_skipped",
    "get_config",
    "get_smoke_config",
]
