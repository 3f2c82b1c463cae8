"""Content-addressed, resumable result store for campaign cells
(counterpart of ``repro.campaign.store``).

Every cell's record is keyed by a canonical hash of its *resolved* config
plus the engine version and the RNG seed (the seed lives inside the
config, so it participates in the hash automatically):

    key = sha256(canonical_json({"config": cfg, "engine": ENGINE_VERSION}))

``canonical_json`` sorts keys and uses Python's shortest-round-trip float
repr, so the hash is invariant to axis ordering and dict insertion order
but changes when any resolved field changes.  The port's engine string
differs from the reference's, so a port result never addresses the same
cell as a reference result; under the reference's string ``cell_key``
gives the reference's key.

Layout on disk::

    <root>/
      index.json            {"version", "engine", "checksum",
                             "cells": {key: shard}}
      bench.json            optional benchmark rows
      shards/cells-00000.jsonl   one JSON record per line

The JSONL shards are the source of truth; ``index.json`` is an
acceleration/debugging view rebuilt on open if missing or stale.  Writes
are crash-tolerant: records are appended + flushed line-at-a-time and a
torn trailing line (a write interrupted mid-record) is skipped on reload,
so an interrupted campaign loses at most the in-flight cell; the index and
``bench.json`` are replaced atomically (temp file + ``os.replace``).

Records separate the deterministic ``result`` payload (what re-runs must
reproduce bit-identically — ``diff_stores`` compares exactly this) from
non-deterministic ``meta`` (wall time, machine).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
from typing import Iterator, Optional

ENGINE_VERSION = "renewal-torch-1"     # bump when engine numerics change
_SHARD_SIZE = 256                      # records per shard file


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, compact separators, no NaN/Inf."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def cell_key(config: dict, engine_version: str = ENGINE_VERSION) -> str:
    """Content address of a normalized cell config (spec.normalize_config)."""
    payload = canonical_json({"config": config, "engine": engine_version})
    return hashlib.sha256(payload.encode()).hexdigest()


def _atomic_write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class ResultStore:
    """One campaign result directory (created on first use)."""

    def __init__(self, root, shard_size: int = _SHARD_SIZE):
        self.root = pathlib.Path(root)
        self.shards_dir = self.root / "shards"
        self.index_path = self.root / "index.json"
        self.bench_path = self.root / "bench.json"
        self.shard_size = shard_size
        self._records: dict = {}
        self._shard_of: dict = {}
        self._n_lines: dict = {}      # shard name -> lines present
        self._load()

    # -- loading ----------------------------------------------------------

    def _load(self) -> None:
        if not self.shards_dir.is_dir():
            return
        self._load_shards()
        if not self._index_valid():
            # missing, torn, stale, or hand-mangled index.json: the shards
            # are the source of truth, so rebuild the view instead of
            # trusting (or crashing on) the acceleration file
            self._write_index()

    def _load_shards(self) -> None:
        for shard in sorted(self.shards_dir.glob("cells-*.jsonl")):
            n = 0
            with open(shard) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        # torn trailing write from an interrupted run; the
                        # cell will simply be recomputed
                        continue
                    self._records[rec["key"]] = rec
                    self._shard_of[rec["key"]] = shard.name
                    n += 1
            self._n_lines[shard.name] = n

    def _cells_checksum(self) -> str:
        return hashlib.sha256(canonical_json(
            dict(sorted(self._shard_of.items()))).encode()).hexdigest()

    def _index_valid(self) -> bool:
        """Does index.json agree with what the shards actually hold?"""
        try:
            idx = json.loads(self.index_path.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        return (isinstance(idx, dict)
                and idx.get("version") == 1
                and idx.get("engine") == ENGINE_VERSION
                and idx.get("cells") == dict(sorted(self._shard_of.items()))
                and idx.get("checksum") == self._cells_checksum())

    # -- queries ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._records)

    def keys(self) -> set:
        return set(self._records)

    def has(self, key: str) -> bool:
        return key in self._records

    def get(self, key: str) -> Optional[dict]:
        return self._records.get(key)

    def records(self) -> Iterator[dict]:
        return iter(list(self._records.values()))

    # -- writes -----------------------------------------------------------

    def _active_shard(self) -> pathlib.Path:
        idx = len(self._records) // self.shard_size
        return self.shards_dir / f"cells-{idx:05d}.jsonl"

    def put(self, key: str, *, labels: dict, config: dict, result: dict,
            meta: Optional[dict] = None) -> dict:
        """Append one completed cell (idempotent per key; atomic enough
        that a kill mid-call costs at most this record)."""
        if key in self._records:
            return self._records[key]
        rec = {"key": key, "labels": dict(labels), "config": config,
               "result": result, "meta": dict(meta or {})}
        canonical_json(rec["result"])     # reject non-finite results early
        self.shards_dir.mkdir(parents=True, exist_ok=True)
        shard = self._active_shard()
        # a torn trailing write leaves the shard without a final newline;
        # appending directly would glue this record onto the fragment and
        # corrupt it too, so heal the line boundary first
        prefix = ""
        if shard.exists() and shard.stat().st_size:
            with open(shard, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    prefix = "\n"
        with open(shard, "a") as f:
            f.write(prefix + canonical_json(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._records[key] = rec
        self._shard_of[key] = shard.name
        self._n_lines[shard.name] = self._n_lines.get(shard.name, 0) + 1
        self._write_index()
        return rec

    def _write_index(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        _atomic_write(self.index_path, json.dumps(
            {"version": 1, "engine": ENGINE_VERSION,
             "checksum": self._cells_checksum(),
             "cells": dict(sorted(self._shard_of.items()))}, indent=1))

    # -- benchmark rows (the regression gate's view of a store) -----------

    def put_bench_rows(self, rows: list) -> None:
        """Attach benchmark rows (the ``name/us_per_call/decisions_per_s/
        derived`` record format) to the store."""
        self.root.mkdir(parents=True, exist_ok=True)
        _atomic_write(self.bench_path, json.dumps(rows, indent=1))

    def bench_rows(self) -> list:
        if self.bench_path.exists():
            return json.loads(self.bench_path.read_text())
        return []


def is_store(path) -> bool:
    """Is ``path`` a campaign result store root?"""
    p = pathlib.Path(path)
    return p.is_dir() and ((p / "index.json").exists()
                           or (p / "shards").is_dir()
                           or (p / "bench.json").exists())


def diff_stores(a_root, b_root) -> list:
    """Compare the deterministic payloads of two stores.

    Returns a list of human-readable differences — empty means every cell
    key present in either store exists in both with a bit-identical
    canonical ``result`` (meta is ignored: wall times differ by nature).
    """
    a, b = ResultStore(a_root), ResultStore(b_root)
    diffs = []
    for key in sorted(a.keys() - b.keys()):
        diffs.append(f"only in {a_root}: {key} ({a.get(key)['labels']})")
    for key in sorted(b.keys() - a.keys()):
        diffs.append(f"only in {b_root}: {key} ({b.get(key)['labels']})")
    for key in sorted(a.keys() & b.keys()):
        ra, rb = a.get(key)["result"], b.get(key)["result"]
        if canonical_json(ra) != canonical_json(rb):
            diffs.append(f"result mismatch at {key} "
                         f"({a.get(key)['labels']})")
    return diffs
