"""Plain oracles of the two LM kernels in model layout, the counterparts of
``repro.kernels.ref``: the model's own reference attention and chunked SSD
scan, shape for shape.  ``kernels.ops`` calls them when asked with
``force_reference=True``."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "ssd_scan_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sliding_window: Optional[int] = None) -> torch.Tensor:
    """Oracle over the model-layout tensors: q (B,S,H,hd), k/v (B,T,K,hd)."""
    from repro_torch.models.attention import gqa_scores_reference

    return gqa_scores_reference(q, k, v, causal=causal,
                                sliding_window=sliding_window)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int):
    """Oracle over the model-layout tensors:
    x (b,s,h,p), dt (b,s,h), a (h,), B/C (b,s,g,n)."""
    from repro_torch.models.ssm import ssd_reference

    return ssd_reference(x, dt, a, bmat, cmat, chunk)
