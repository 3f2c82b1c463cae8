"""Shape-bucket batching helpers of the serve CLI (numpy only), the
counterpart of ``repro.launch.batching``.

Production batchers quantize batch sizes to a small set of buckets, pad
requests up to the bucket, run the program, and slice/scatter the answers
back in request order: one program shape (one CUDA graph, one set of
kernel launches) per bucket instead of one per request count.

Padding contract: ``pad_rows`` repeats the LAST row.  Decode batch rows
are independent, so duplicated tail rows cannot perturb the real rows'
results; they are sliced off before anything is returned.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Sequence

import numpy as np

__all__ = [
    "DEFAULT_BUCKETS",
    "bucket_size",
    "pad_rows",
    "group_indices",
    "scatter",
]

# powers of two up to 1024: at most 2x padding waste, and ~10 compiled
# programs cover every batch size a host-side server sees.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                multiple_of: int = 1) -> int:
    """Smallest bucket >= ``n`` that is a multiple of ``multiple_of``.

    ``multiple_of`` is the device count on the sharded path (every shard
    must receive equal rows).  Batches beyond the largest bucket fall back
    to the next exact multiple of ``multiple_of`` — an unbounded request
    burst still gets one program rather than an error.
    """
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    if multiple_of <= 0:
        raise ValueError(f"multiple_of must be positive, got {multiple_of}")
    for b in sorted(buckets):
        if b >= n and b % multiple_of == 0:
            return int(b)
    return int(-(-n // multiple_of) * multiple_of)


def pad_rows(rows, size: int):
    """Pad ``rows`` (list, or array along axis 0) to ``size`` by repeating
    the last row.  Returns the same container type; no-op when already at
    ``size``."""
    n = len(rows)
    if n == 0:
        raise ValueError("cannot pad an empty batch (no row to repeat)")
    if n > size:
        raise ValueError(f"batch of {n} rows does not fit bucket {size}")
    if n == size:
        return rows
    if isinstance(rows, np.ndarray):
        reps = [(0, size - n)] + [(0, 0)] * (rows.ndim - 1)
        return np.pad(rows, reps, mode="edge")
    return list(rows) + [rows[-1]] * (size - n)


def group_indices(keys: Sequence[Hashable]) -> Dict[Hashable, List[int]]:
    """Group request positions by bucket key, preserving first-seen group
    order and within-group request order — the forward half of the
    group -> pad -> dispatch -> scatter round trip."""
    groups: Dict[Hashable, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def scatter(groups: Dict[Hashable, List[int]], results: Dict[Hashable, list]) -> list:
    """Invert ``group_indices``: place each group's per-request results
    (padding already sliced off) back into original request order."""
    n = sum(len(idx) for idx in groups.values())
    out = [None] * n
    for key, idx in groups.items():
        res = results[key]
        if len(res) != len(idx):
            raise ValueError(
                f"group {key!r}: {len(res)} results for {len(idx)} requests "
                "(padding must be sliced off before scatter)")
        for i, r in zip(idx, res):
            out[i] = r
    return out
