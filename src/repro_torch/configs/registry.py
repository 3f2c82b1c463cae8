"""Architecture registry and the assigned input-shape grid (pure data), the
counterpart of ``repro.configs.registry``.

Every assigned architecture ships a ``config()`` (the published numbers)
and a ``smoke_config()`` (same family, tiny widths) in its own module.
``input_specs`` and ``grid`` belong to the dry-run and are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.api import ModelConfig

ARCHS = (
    "qwen2-vl-72b",
    "deepseek-7b",
    "command-r-plus-104b",
    "gemma-7b",
    "qwen2-72b",
    "zamba2-7b",
    "whisper-medium",
    "mamba2-370m",
    "mixtral-8x22b",
    "olmoe-1b-7b",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k runs only for sub-quadratic archs (SSM / hybrid / SWA)
LONG_CONTEXT_ARCHS = frozenset({"mamba2-370m", "zamba2-7b", "mixtral-8x22b"})


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    """Return a skip reason, or None if the (arch, shape) cell runs."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None
