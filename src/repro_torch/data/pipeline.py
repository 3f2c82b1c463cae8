"""Deterministic synthetic token pipeline, the counterpart of
``repro.data.pipeline``.

Every batch is a pure function of ``(seed, step)`` through counter-based
hashing (``core.prng``'s threefry, bit-compatible with ``jax.random``), so
there is no pipeline state to checkpoint: a recovering pod regenerates the
exact batches of its re-execution window without coordination, and
re-executed steps are bit-identical.  The tokens for a ``(seed, step)`` are
the reference's, bit for bit.  Batches are drawn on the pipeline's device.
"""
from __future__ import annotations

import dataclasses


from repro_torch._device import resolve_device
from repro_torch.core import prng

__all__ = ["SyntheticLM", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str = "cuda"

    def batch_at(self, step: int) -> dict:
        """Tokens/labels (int32, on ``device``) for a step (stateless,
        replayable)."""
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        tokens = prng.randint(key, (self.global_batch, self.seq_len + 1), 0,
                              self.vocab_size, resolve_device(self.device))
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def host_batch_at(self, step: int) -> dict:
        """The same batch as numpy arrays."""
        return {k: v.cpu().numpy() for k, v in self.batch_at(step).items()}


def make_pipeline(cfg, shape, device="cuda") -> SyntheticLM:
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                       global_batch=shape.global_batch, device=device)
