"""The comparison that decides ``correct``.

Each checked prompt's last-position logits from the timed prefill are held
against the plain reference's, over the real vocabulary (the port pads its
head).  The numbers:

* ``logit_rel_err``: the worst prompt's ``|got - ref| / |ref - mean(ref)|``
  over its row, the error of the whole distribution;
* ``logit_rel_err_median``: the same, of the median prompt — the steady
  number where discrete events (an expert route flipping on a near tie)
  give single prompts a heavy tail;
* ``top_token_gap``: the worst prompt's distance, in logits, from the
  reference's best logit down to the reference's logit of the program's
  greedy token: the answer a greedy client would be served.

A non-finite logit makes a prompt's numbers infinite.  Each cell's limits
are in ``limits/<cell>.json``; a number whose limit is ``null`` is not
compared there (``PERF.md`` gives its readings and why).  A prompt fails
when it breaks a limit of its own (the worst-prompt numbers), or, when the
median breaks its limit, when its error is above that limit.

Where the limits give a ``tie_margin``, a prompt whose routing at the last
position is a near tie in the reference (``reference/<config>.py``
``tie_margin``, in some layer under the limit) is left out of the
worst-prompt numbers: rounding may turn that route, and the answer with it.
It still counts in the median.  The rule reads the reference alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

NUMBERS = ("logit_rel_err", "logit_rel_err_median", "top_token_gap")


def row_numbers(got: np.ndarray, ref: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-prompt errors of ``got`` (rows, V) against ``ref`` (rows, V):
    ``logit_rel_err`` and ``top_token_gap``."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"logits {got.shape} against reference {ref.shape}")
    finite = np.isfinite(got).all(axis=1)
    centred = ref - ref.mean(axis=1, keepdims=True)
    rel = np.linalg.norm(np.where(np.isfinite(got), got, 0.0) - ref, axis=1) \
        / np.linalg.norm(centred, axis=1)
    picked = np.take_along_axis(
        ref, np.nan_to_num(got, nan=-np.inf).argmax(axis=1)[:, None], 1)[:, 0]
    gap = ref.max(axis=1) - picked
    return {"logit_rel_err": np.where(finite, rel, np.inf),
            "top_token_gap": np.where(finite, gap, np.inf)}


def numbers(per_row: Dict[str, np.ndarray],
            kept: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The compared numbers of a set of prompts; the worst-prompt ones over
    the ``kept`` prompts (every prompt by default; 0 where none is)."""
    rel = per_row["logit_rel_err"]
    kept = np.ones(rel.shape, dtype=bool) if kept is None else kept

    def worst(values):
        return float(values[kept].max()) if kept.any() else 0.0

    return {"logit_rel_err": worst(rel),
            "logit_rel_err_median": float(np.median(rel)),
            "top_token_gap": worst(per_row["top_token_gap"])}


def judge(got: np.ndarray, ref: np.ndarray,
          limits: Dict[str, Optional[float]],
          kept: Optional[np.ndarray] = None) -> Tuple[Dict[str, dict], int]:
    """The compared numbers beside their limits, and the count of prompts
    that fail."""
    per_row = row_numbers(got, ref)
    kept = np.ones(got.shape[0], dtype=bool) if kept is None else kept
    found = numbers(per_row, kept)
    bad = np.zeros(got.shape[0], dtype=bool)
    for name in ("logit_rel_err", "top_token_gap"):
        if limits.get(name) is not None:
            bad |= kept & ~(per_row[name] <= limits[name])
    median = limits.get("logit_rel_err_median")
    if median is not None and not found["logit_rel_err_median"] <= median:
        bad |= ~(per_row["logit_rel_err"] <= median)
    return ({name: {"value": found[name], "limit": float(limits[name])}
             for name in NUMBERS if limits.get(name) is not None},
            int(bad.sum()))
