"""The one traffic generator: every mix is a ``traffic/<mix>.json`` of
parameters that this module reads.

Keys of a mix:

* ``loop``: ``"closed"`` — one client, one batch in flight; the next batch
  is sent when the previous one's answers are on the host;
* ``batch``, ``prompt_len``: prompts per batch and tokens per prompt;
* ``ids``: the law the token ids are drawn from, ``{"law": "uniform"}``
  over the vocabulary;
* ``distinct_batches``: batches made at set-up; the window sends them in
  turn, starting again from the first if it runs through all of them.

Every seed gives the same sizes; only the ids differ.
"""
from __future__ import annotations

import numpy as np
import torch

LAWS = ("uniform",)


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of a run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed":
        raise ValueError(f"loop {mix.get('loop')!r}: only 'closed' is generated")
    if mix["ids"]["law"] not in LAWS:
        raise ValueError(f"ids law {mix['ids']['law']!r} not in {LAWS}")
    for key in ("batch", "prompt_len", "distinct_batches"):
        if int(mix[key]) < 1:
            raise ValueError(f"{key} must be at least 1")


def make_pool(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(distinct_batches, batch, prompt_len) int64 token ids on ``device``,
    drawn from the seed in one call."""
    check_mix(mix)
    shape = (int(mix["distinct_batches"]), int(mix["batch"]),
             int(mix["prompt_len"]))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int64)
