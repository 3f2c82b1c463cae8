"""Architecture registry and the assigned input-shape grid (pure data), the
counterpart of ``repro.configs.registry``.

Every assigned architecture ships a ``config()`` (the published numbers)
and a ``smoke_config()`` (same family, tiny widths) in its own module.
The registry exposes lookup, the shape grid, skip logic for ``long_500k``
(sub-quadratic archs only) and ``input_specs``, whose ``meta`` tensors
stand in for a step's inputs in the dry run (no storage).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

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


def grid():
    """All non-skipped (arch, shape) cells — the dry-run grid."""
    return [
        (a, s) for a in ARCHS for s in SHAPES
        if cell_is_skipped(a, s) is None
    ]


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract inputs for the step function of the given kind.

    train/prefill -> full-sequence batch; decode -> one new token plus the
    position scalar (the KV cache is part of the state, see launch/dryrun).
    """
    b = shape.global_batch
    s = shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.encdec.enc_len, cfg.d_model),
                                    cfg.activation_dtype)
            batch["tokens"] = _meta((b, s), i32)
        elif cfg.embeds_input:
            batch["embeds"] = _meta((b, s, cfg.d_model), cfg.activation_dtype)
            if cfg.mrope_sections is not None:
                batch["mrope_positions"] = _meta(
                    (len(cfg.mrope_sections), b, s), i32)
        else:
            batch["tokens"] = _meta((b, s), i32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32), "pos": _meta((), i32)}
    raise ValueError(shape.kind)
