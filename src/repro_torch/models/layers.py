"""Shared layers: RMSNorm, LayerNorm, rotary embeddings (RoPE and
sectioned M-RoPE) and token embedding, the counterparts of
``repro.models.layers``.  Plain functions over explicit parameter tensors.

``embed``'s backward sums the rows of repeated tokens in a fixed order (a
stable sort, then a pairwise tree per token), on the CPU and the card
alike: an accumulating scatter would add them in whatever order its
atomics land, and the FT runtime's re-executed steps must be bit-identical.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.parallel.dtensor_ops import (fsdp_gather, sharded_embed,
                                              tp_dense)

__all__ = ["rms_norm", "model_rms_norm", "layer_norm", "rope_frequencies", "apply_rope",
           "apply_mrope", "embed", "dense"]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K), w (K, N) as one (M, K) x (K, N) product:
    the fold ``torch.matmul`` makes of a contiguous x, made explicit.  A
    DTensor with a size-1 dim (one decode token) carries strides that stop
    matmul from folding it, and the batched product it takes instead
    rounds differently.  A DTensor weight is gathered over the mesh dims
    that shard x's tokens (``parallel.dtensor_ops.fsdp_gather``) and the
    product is each rank's own (``tp_dense``)."""
    return tp_dense(x, fsdp_gather(w, x, range(x.ndim - 1)))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with float32 accumulation and a ``1 + weight`` scale."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def model_rms_norm(x: torch.Tensor, weight: torch.Tensor, cfg) -> torch.Tensor:
    """``rms_norm(x, weight, cfg.norm_eps)`` as a model runs it: through
    ``kernels.ops.rms_norm`` when ``cfg.use_flash_kernel`` (the CUDA kernel
    on the card, ``rms_norm`` itself on the CPU), else ``rms_norm``."""
    if cfg.use_flash_kernel:
        from repro_torch.kernels import ops as kops
        return kops.rms_norm(x, weight, cfg.norm_eps)
    return rms_norm(x, weight, cfg.norm_eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 over the population variance (``jnp.var``),
    returned in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


@functools.lru_cache(maxsize=None)
def host_table(fn, device: torch.device, *args) -> torch.Tensor:
    """``fn(*args, device="cpu")`` copied to ``device``, once per arguments
    and device.  A constant table built on a card is not the CPU's bits:
    CUDA divides by a Python number through its reciprocal, and its pow,
    exp, sin and cos differ from the CPU's by an ulp on some arguments
    (ROADMAP.md Queue 3, item 17).  Callers must not write into it."""
    return fn(*args, device="cpu").to(device)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies, on a card the CPU's bits
    (``host_table``)."""
    if device is not None and torch.device(device).type == "cuda":
        return host_table(rope_frequencies, torch.device(device), head_dim,
                          theta)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    """Rotate pairs laid out as [x0..x_{d/2-1} | x_{d/2}..x_{d-1}] (HF layout)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Standard RoPE.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal rotary embedding (Qwen2-VL).  ``positions``:
    (n_sections, ..., seq); ``sections`` splits the head_dim/2 frequency
    bands among the position components."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    if sum(sections) != inv.shape[0]:
        raise ValueError(f"sections {sections} do not cover {inv.shape[0]} bands")
    idx = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])       # (hd/2,)
    pos = torch.movedim(positions.index_select(0, idx), 0, -1)  # (..., seq, hd/2)
    angles = pos.float() * inv
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``, cast to ``dtype``; its backward is
    deterministic (module doc).  A ``DTensor`` table goes through
    ``parallel.dtensor_ops.sharded_embed``."""
    return sharded_embed(_Embed.apply, table, tokens).to(dtype)


def _segment_sum_rows(idx: torch.Tensor, rows: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """(n, D) sums of ``rows`` (N, D) grouped by ``idx`` (N,), in float32 or
    wider, the same bits on every run: rows sorted stably by index, each
    group summed as a pairwise tree in the rows' original order."""
    acc = torch.promote_types(rows.dtype, torch.float32)
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    vals = rows.to(acc)[order]
    uniq, counts = torch.unique_consecutive(sidx, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(idx.numel(), device=idx.device) \
        - torch.repeat_interleave(starts, counts)
    size = torch.repeat_interleave(counts, counts)
    k, longest = 1, int(counts.max())
    while k < longest:
        sel = torch.nonzero((pos % (2 * k) == 0) & (pos + k < size))[:, 0]
        vals[sel] = vals[sel] + vals[sel + k]       # distinct rows: no race
        k *= 2
    out = torch.zeros((n, rows.shape[1]), dtype=acc, device=rows.device)
    out[uniq] = vals[starts]
    return out


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.n_rows, ctx.table_dtype = table.shape[0], table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        d = grad.shape[-1]
        table_grad = _segment_sum_rows(tokens.reshape(-1), grad.reshape(-1, d),
                                       ctx.n_rows)
        return table_grad.to(ctx.table_dtype), None
