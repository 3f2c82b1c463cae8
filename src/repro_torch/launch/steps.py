"""Step functions of the serving path, the counterparts of
``repro.launch.steps``: the prefill step (a forward over the prompt that
returns the last position's logits) and the one-token decode step, both
under ``torch.inference_mode``.  The train step waits: neither LM kernel
has a backward yet."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import Model

__all__ = ["cross_entropy", "make_prefill_step", "make_serve_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy; labels < 0 are masked."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


def make_prefill_step(model: Model) -> Callable:
    """Forward-only full-sequence step; returns the last-position logits."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode step with a KV/SSM cache (updated in place); returns
    the greedy next token (int32) and the cache."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32), cache

    return serve_step
