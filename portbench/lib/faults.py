"""Faults planted under the timed path, to show that the comparison catches
them (``tests/test_portbench_faults.py``, ``control.py``).  Each wraps the
port's prefill step, whose output is a batch's last-position logits:

* ``answer``: each prompt's greedy token replaced where it is produced, by
  raising one other logit (drawn from a fixed stream) above the row's best;
* ``rows``: half of the batch left out, its answers copied from the other
  half;
* ``stale``: the step hands back the previous batch's answers (its state
  unchanged); the first call runs.
"""
from __future__ import annotations

import torch

FAULTS = ("answer", "rows", "stale")


def wrap(step, fault: str, vocab: int):
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    state = {"calls": 0, "previous": None}

    def broken(params, batch):
        out = step(params, batch)
        state["calls"] += 1
        if fault == "answer":
            out = out.clone()
            gen = torch.Generator().manual_seed(state["calls"])
            other = torch.randint(0, vocab, (out.shape[0],), generator=gen)
            best = out[:, :vocab].argmax(1).cpu()
            other = torch.where(other == best, (other + 1) % vocab, other)
            rows = torch.arange(out.shape[0], device=out.device)
            out[rows, other.to(out.device)] = out[:, :vocab].max(1).values + 1.0
        elif fault == "rows":
            half = out.shape[0] // 2
            out = torch.cat([out[: out.shape[0] - half], out[:half]])
        else:
            previous, state["previous"] = state["previous"], out
            if previous is not None:
                out = previous
        return out

    return broken
