"""Gradient compression for cross-pod reduction, the counterpart of
``repro.parallel.compression``: top-k sparsification and int8 quantization,
both with error feedback, so the compression error stays in a local
float32 residual instead of being lost.  ``wrap_optimizer`` composes with
any ``repro_torch.optim`` Optimizer.

Top-k keeps the ``max(1, int(n * ratio))`` entries of largest magnitude;
where several entries tie at the cut, ``torch.topk`` may keep others than
XLA's ``top_k``, so the kept indices are not part of the contract: what is
sent and what stays in the residual always add up to the compressed input.
``torch.round`` rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.optim.adamw import Optimizer

__all__ = ["CompressionConfig", "topk_compress", "topk_decompress",
           "int8_compress", "int8_decompress", "wrap_optimizer",
           "compression_ratio"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    method: str = "topk"        # topk | int8 | none
    topk_ratio: float = 0.05    # fraction of entries kept


def topk_compress(g: torch.Tensor, ratio: float):
    """(kept values float32, their flat indices, g's shape)."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * ratio))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, tuple(g.shape)


def topk_decompress(kept: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=torch.float32, device=kept.device)
    flat[idx] = kept
    return flat.reshape(shape)


def int8_compress(g: torch.Tensor):
    """(int8 codes, float32 scale): ``max |g| / 127`` per tensor.  The
    divisor is a tensor: CUDA multiplies by the reciprocal of a Python
    number instead of dividing, which rounds otherwise than the CPU (and
    the reference) for some scales."""
    amax = torch.clamp_min(g.abs().max(), 1e-12)
    scale = amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device)
    q = torch.round(g / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress_tree(grads, residual, cfg: CompressionConfig):
    """Compression with error feedback, leaf by leaf: returns (the
    decompressed gradients as they would arrive after the wire, the new
    residual)."""

    def leaf(g, r):
        g = g.float() + r
        if cfg.method == "topk":
            out = topk_decompress(*topk_compress(g, cfg.topk_ratio))
        elif cfg.method == "int8":
            out = int8_decompress(*int8_compress(g))
        else:
            out = g
        return out, g - out

    pairs = [leaf(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    sent, res = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(sent), grads),
            tree_map(lambda _: next(res), grads))


def wrap_optimizer(base: Optimizer, cfg: CompressionConfig) -> Optimizer:
    """Optimizer whose update sees compressed, error-fed-back gradients.
    State: ``{"base": <base state>, "residual": <float32, params' shapes and
    devices>}``."""

    def init(params):
        return {"base": base.init(params),
                "residual": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params):
        sent, residual = _compress_tree(grads, state["residual"], cfg)
        new_params, new_base = base.update(sent, state["base"], params)
        return new_params, {"base": new_base, "residual": residual}

    return Optimizer(init=init, update=update)


def compression_ratio(cfg: CompressionConfig, dtype_bytes: int = 4) -> float:
    """Wire bytes against uncompressed float32 (the cross-pod collective
    bytes scale by this factor)."""
    if cfg.method == "topk":
        # float32 values + int32 indices per kept entry
        return cfg.topk_ratio * (4 + 4) / dtype_bytes
    if cfg.method == "int8":
        return 1.0 / dtype_bytes
    return 1.0
