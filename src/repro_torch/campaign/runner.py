"""Chunked device dispatch for campaign cells (counterpart of
``repro.campaign.runner``).

The runner turns a validated ``CampaignSpec`` into stored results:

1. **Resolve + skip** — each cell's normalized config hashes to its
   content address (``store.cell_key``); cells already present in the
   store are skipped, which is all there is to resume semantics.
2. **Group by static shape** — cells whose dispatches can share one scan
   call: same survivor count, ladder size, blocking topology, failure
   process, (n_runs, max_failures), and seed.  Within a group, arbitrary
   scenario/policy variation rides the lane axis of the float64 scan
   (every ``SweepInputs`` leaf stacked, a per-lane makespan), so
   heterogeneous resolved configs stack as lanes of ONE
   ``sweep.renewal_monte_carlo_policies`` call on ``device``.
3. **Chunk to a memory budget** — lanes multiply the scan's working set
   (~``2 * n_runs * max_failures * (96 + 88 * n_nodes)`` bytes per lane:
   the per-(run, epoch) float64 geometry carry plus the per-node decision
   intermediates); chunks are sized so a campaign of thousands of cells
   never materializes more than ``chunk_budget_mb`` at once.  Chunking is
   invisible in the results: gap sampling never sees the lane axis (common
   random numbers), so a cell's stored record is bit-identical whatever
   chunk it lands in.
4. **Scatter** — each lane's whole-run statistics reduce to the same
   ``RenewalMonteCarloSummary`` fields the scenario path emits
   (``sweep._summarize_device_scenario``), serialized as the record's
   deterministic ``result`` payload and written cell-at-a-time, so an
   interrupted run keeps every finished cell.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import failures, prng, sweep
from repro_torch.campaign import spec as spec_mod
from repro_torch.campaign import store as store_mod

DEFAULT_CHUNK_BUDGET_MB = 256.0

# resolved-experiment memo keyed by content address: a cell key pins the
# whole normalized config, so equal keys resolve to equal experiments.
# Keeps repeated run_campaign calls (resume loops) from paying scenario
# construction again; bounded.
_RESOLVE_CACHE: dict = {}
_RESOLVE_CACHE_MAX = 4096


def _machine_fingerprint() -> str:
    import os
    import platform
    return f"{platform.system()}-{platform.machine()}-cpu{os.cpu_count()}"


def summary_to_result(summ) -> dict:
    """Serialize a ``RenewalMonteCarloSummary`` to the JSON result payload
    (histogram keys stringified, tuples listified — canonical-JSON safe).
    Flat field walk rather than ``dataclasses.asdict``: the summary is all
    scalars plus one dict and one tuple, and asdict's deepcopy recursion
    dominates the scatter cost at campaign scale."""
    d = {f.name: getattr(summ, f.name) for f in dataclasses.fields(summ)}
    d["failure_count_hist"] = {
        str(k): v for k, v in sorted(summ.failure_count_hist.items())}
    d["per_node_failures"] = list(summ.per_node_failures)
    return d


@dataclasses.dataclass(frozen=True)
class CellRun:
    """One pending cell: spec view + engine view + content address."""

    cell: spec_mod.ResolvedCell
    exp: spec_mod.ResolvedExperiment
    key: str


@dataclasses.dataclass
class RunReport:
    """What one ``run_campaign`` call did."""

    name: str
    n_total: int
    n_skipped: int
    n_computed: int
    n_chunks: int
    wall_s: float
    decisions: int
    records: list            # records in spec cell order (skipped included)

    @property
    def cells_per_s(self) -> float:
        return self.n_computed / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def decisions_per_s(self) -> float:
        return self.decisions / self.wall_s if self.wall_s > 0 else 0.0


def _group_signature(run: CellRun) -> tuple:
    """Cells sharing this signature stack into one fused dispatch."""
    cfg, exp = run.exp.cfg, run.exp
    return (
        store_mod.canonical_json(run.cell.config["process"]),
        store_mod.canonical_json(run.cell.config.get("topology") or {}),
        exp.n_runs, exp.max_failures, exp.seed,
        len(cfg.survivors),
        tuple(s.peer for s in cfg.survivors),
        cfg.profile.power_table.num_levels,
    )


def _chunk_lanes(n_lanes: int, exp: spec_mod.ResolvedExperiment,
                 chunk_budget_mb: float) -> int:
    n_nodes = len(exp.cfg.survivors) + 1
    per_lane = 2.0 * exp.n_runs * exp.max_failures * (96 + 88 * n_nodes)
    budget = chunk_budget_mb * 1e6
    return int(max(1, min(n_lanes, budget // max(per_lane, 1.0))))


def _dispatch_chunk(chunk: list, progress, device) -> list:
    """One scan call for up to ``len(chunk)`` heterogeneous cells on
    ``device``; returns the per-cell result payloads in chunk order."""
    exp0 = chunk[0].exp
    proc = exp0.process
    mtbf = float(np.mean(failures.as_process(proc).mean_s()))
    cfgs = [r.exp.cfg for r in chunk]
    makespans = np.asarray([r.exp.makespan_s for r in chunk], np.float64)
    # float64 stacking, the renewal preconditions checked per config
    _, stacked = sweep._renewal_device_inputs(cfgs, torch.float64, device)
    stats = sweep._stats_to_host(sweep.renewal_monte_carlo_policies(
        stacked, prng.PRNGKey(exp0.seed), makespan_s=makespans,
        n_runs=exp0.n_runs, max_failures=exp0.max_failures,
        process=proc, topology=exp0.topology, stats=True))
    end_time = np.asarray(stats["end_time"], np.float64)
    out = []
    for i, r in enumerate(chunk):
        summ = sweep._summarize_device_scenario(
            stats, i, n_runs=exp0.n_runs, makespan_s=float(makespans[i]),
            mtbf_s=mtbf, max_failures=exp0.max_failures)
        result = summary_to_result(summ)
        # realized mean wall makespan (failures stretch the run past the
        # failure-free makespan_s input) — the optimizer's second objective
        result["mean_makespan_s"] = float(end_time[i].mean())
        out.append(result)
    if progress:
        progress(f"  dispatched {len(chunk)} lanes "
                 f"({exp0.n_runs}x{exp0.max_failures} runs x epochs)")
    return out


def run_campaign(
    campaign: spec_mod.CampaignSpec,
    store: Optional[store_mod.ResultStore] = None,
    *,
    limit: Optional[int] = None,
    chunk_budget_mb: float = DEFAULT_CHUNK_BUDGET_MB,
    progress: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> RunReport:
    """Run every pending cell of ``campaign`` on ``device``; returns the
    records.

    ``store=None`` keeps results in memory only (ad-hoc runs).  ``limit``
    caps the number of cells *computed* this call — the deterministic
    stand-in for an interrupted run: the first ``limit`` pending cells
    (spec order) complete and everything else stays pending.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    runs = []
    for cell in campaign.cells:
        key = store_mod.cell_key(cell.config)
        exp = _RESOLVE_CACHE.get(key)
        if exp is None:
            try:
                exp = spec_mod.resolve(cell.config)
                sweep._check_renewal_config(exp.cfg)
            except ValueError as e:
                raise ValueError(f"cell {cell.cell_id()}: {e}") from e
            if len(_RESOLVE_CACHE) >= _RESOLVE_CACHE_MAX:
                _RESOLVE_CACHE.clear()
            _RESOLVE_CACHE[key] = exp
        runs.append(CellRun(cell=cell, exp=exp, key=key))

    done: dict = {}
    pending = []
    for r in runs:
        if store is not None and store.has(r.key):
            done[r.key] = store.get(r.key)
        else:
            pending.append(r)
    n_skipped = len(done)
    if limit is not None:
        pending = pending[:limit]

    # group by dispatch signature, preserving first-seen order
    groups: dict = {}
    for r in pending:
        groups.setdefault(_group_signature(r), []).append(r)

    n_chunks = 0
    decisions = 0
    meta_base = {"machine": _machine_fingerprint(),
                 "campaign": campaign.name}
    for sig, members in groups.items():
        lanes = _chunk_lanes(len(members), members[0].exp, chunk_budget_mb)
        for lo in range(0, len(members), lanes):
            chunk = members[lo:lo + lanes]
            tc = time.perf_counter()
            results = _dispatch_chunk(chunk, progress, dev)
            wall = time.perf_counter() - tc
            n_chunks += 1
            for r, result in zip(chunk, results):
                decisions += (r.exp.n_runs * r.exp.max_failures
                              * len(r.exp.cfg.survivors))
                meta = dict(meta_base, wall_s=wall / len(chunk))
                if store is not None:
                    rec = store.put(r.key, labels=r.cell.label_dict,
                                    config=r.cell.config, result=result,
                                    meta=meta)
                else:
                    rec = {"key": r.key, "labels": r.cell.label_dict,
                           "config": r.cell.config, "result": result,
                           "meta": meta}
                done[r.key] = rec

    wall_s = time.perf_counter() - t0
    records = [done[r.key] for r in runs if r.key in done]
    report = RunReport(
        name=campaign.name, n_total=len(runs), n_skipped=n_skipped,
        n_computed=len(done) - n_skipped, n_chunks=n_chunks, wall_s=wall_s,
        decisions=decisions, records=records)
    if progress:
        progress(f"{campaign.name}: {report.n_computed} computed, "
                 f"{report.n_skipped} skipped, {n_chunks} dispatches, "
                 f"{wall_s:.2f}s ({report.cells_per_s:.1f} cells/s)")
    return report
