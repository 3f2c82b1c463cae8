"""Shared layers: RMSNorm, rotary embeddings (RoPE and sectioned M-RoPE)
and token embedding, the counterparts of ``repro.models.layers``.  Plain
functions over explicit parameter tensors.  ``layer_norm`` waits for the
encoder-decoder family."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "apply_mrope",
           "embed"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with float32 accumulation and a ``1 + weight`` scale."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
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
    return table[tokens.long()].to(dtype)
