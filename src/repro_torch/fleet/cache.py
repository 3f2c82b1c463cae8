"""Per-bucket program memoization for the fleet dispatch (counterpart of
``repro.fleet.cache``).

A serving process needs a BOUND on the programs it keeps (every (clusters,
policies, nodes) bucket is a program of its own), OBSERVABILITY (did this
request reuse a bucket's program or build one?) and real EVICTION.
``DispatchCache`` holds one program per *bucket key* — the static-shape
tuple the serving layer quantizes requests to — in a bounded LRU.  A
program is the fleet core closed over its static arguments, wrapped by the
cache's ``compile`` factory (identity by default; the sharded advisor
passes its per-device splitter).  ``traces`` counts the first call of each
entry: the reference's jit traces once per entry at a fixed bucket shape,
and the port has no trace to pay, so a repeat fleet shape shows as a hit
with no new trace; a new node-count bucket is a miss; beyond
``max_entries`` the least-recently-used program is dropped.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, Optional

__all__ = ["DispatchCache", "CacheStats"]


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Counters snapshot: bucket-level hits/misses/evictions plus the total
    number of first calls paid (across live AND evicted entries — a
    program rebuilt after an eviction shows up here)."""

    hits: int
    misses: int
    evictions: int
    traces: int
    entries: int


class _Entry:
    __slots__ = ("call", "traces")

    def __init__(self, fn: Callable, compile_fn: Callable):
        self.traces = [0]
        program = compile_fn(fn)

        def counted(*args, **kw):
            if not self.traces[0]:
                self.traces[0] = 1      # the entry's first call
            return program(*args, **kw)

        self.call = counted


class DispatchCache:
    """Bounded LRU of per-bucket programs around one function.

    ``get(bucket_key)`` returns the bucket's callable, creating (and
    possibly evicting) as needed.  The caller owns the bucket-key
    discipline: every call through one entry uses the padded shapes that
    key encodes.  ``compile`` wraps ``fn`` once per entry.
    """

    def __init__(self, fn: Callable, *, max_entries: int = 8,
                 compile: Optional[Callable] = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._fn = fn
        self._compile = compile if compile is not None else (lambda f: f)
        self._max = max_entries
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._evicted_traces = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, bucket_key: Hashable) -> bool:
        return bucket_key in self._entries

    def get(self, bucket_key: Hashable) -> Callable:
        entry = self._entries.get(bucket_key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(bucket_key)
            return entry.call
        self.misses += 1
        entry = _Entry(self._fn, self._compile)
        self._entries[bucket_key] = entry
        while len(self._entries) > self._max:
            _, dropped = self._entries.popitem(last=False)
            self._evicted_traces += dropped.traces[0]
            self.evictions += 1
        return entry.call

    def trace_count(self, bucket_key: Hashable) -> int:
        """First calls paid by the LIVE entry for ``bucket_key`` (0 if
        absent or not yet called, 1 after)."""
        entry = self._entries.get(bucket_key)
        return entry.traces[0] if entry is not None else 0

    def stats(self) -> CacheStats:
        live = sum(e.traces[0] for e in self._entries.values())
        return CacheStats(hits=self.hits, misses=self.misses,
                          evictions=self.evictions,
                          traces=live + self._evicted_traces,
                          entries=len(self._entries))

    def clear(self) -> None:
        for _, dropped in self._entries.items():
            self._evicted_traces += dropped.traces[0]
        self.evictions += len(self._entries)
        self._entries.clear()
