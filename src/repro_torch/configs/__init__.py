"""Assigned-architecture configs, the shape grid and the dry run's abstract
inputs."""
from repro_torch.configs.registry import (
    ARCHS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ShapeSpec,
    cell_is_skipped,
    get_config,
    get_smoke_config,
    grid,
    input_specs,
)

__all__ = [
    "ARCHS",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "ShapeSpec",
    "cell_is_skipped",
    "get_config",
    "get_smoke_config",
    "grid",
    "input_specs",
]
