"""The fleet advisory service: requests in, tuned policies out, one scan per
shape bucket (counterpart of ``repro.fleet.advisor``).

Serving protocol (the serve loop's recipe applied to policy tuning):

  1. **accumulate** — ``submit`` queues ``ClusterProfile`` requests;
  2. **group** — ``flush`` partitions pending requests by their static
     dispatch signature (survivor count, process family);
  3. **pad** — each group is padded up to a batch bucket by repeating its
     last request (inert: cluster lanes are independent, so padded lanes
     cannot perturb real answers);
  4. **dispatch** — one ``(C, P)`` float64 scan per bucket on the
     advisor's device, its program memoized per bucket key
     (``DispatchCache``);
  5. **scatter** — per-cluster optima return in original submit order.

Every answer is bit-identical (CRN, the advisor's fixed key) to a
standalone ``optimize_policy`` call for that cluster alone on the same
device — batching is a throughput decision, never an accuracy one.

``shard=True`` splits the padded cluster axis over the visible CUDA
devices: one chunk per card, each run on its own device with the key
broadcast, so per-cluster rows stay bit-identical to the unsharded path.
On the CPU, and on a machine with one card, the split has one part.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import failures, optimize, prng, sweep
from repro_torch.fleet.cache import CacheStats, DispatchCache
from repro_torch.fleet.profiles import ClusterProfile
from repro_torch.launch.batching import (
    DEFAULT_BUCKETS,
    bucket_size,
    group_indices,
    pad_rows,
    scatter,
)

__all__ = ["Advisory", "FleetAdvisor"]


@dataclasses.dataclass(frozen=True)
class Advisory:
    """One answered request: the profile it was asked for and its tuned
    policy.  ``best``/``knee`` are policy dicts (knobs + objectives);
    ``optimum`` keeps the full per-cluster grid for auditing."""

    request_id: int
    profile: ClusterProfile
    optimum: optimize.PolicyOptimum

    @property
    def best(self) -> dict:
        return self.optimum.best

    @property
    def knee(self) -> dict:
        return self.optimum.knee


def _process_rows(proc: failures.FailureProcess, lo: int, hi: int):
    """Clusters ``lo:hi`` of a cluster-stacked process."""
    return type(proc)(**{f.name: np.asarray(getattr(proc, f.name))[lo:hi]
                         for f in dataclasses.fields(proc)})


def _inputs_to(stacked: sweep.SweepInputs, lo: int, hi: int,
               dev: torch.device) -> sweep.SweepInputs:
    """Clusters ``lo:hi`` of a ``(C, P)`` stack, moved to ``dev``."""
    return sweep._map_leaves(lambda xs: xs[0][lo:hi].to(dev), [stacked])


class FleetAdvisor:
    """Batched policy-advisory service over one shared policy grid.

    ``table`` is the grid every request is scored on (default: the
    standard grid of the default ``ClusterProfile`` at the engine's 14-day
    MTBF anchor); ``key`` (default ``prng.PRNGKey(0)``) fixes the CRN
    draws, making every advisory reproducible and bit-comparable to a
    standalone ``optimize_policy`` call.  ``max_cached_programs`` bounds
    the memoized bucket programs (LRU); ``buckets`` quantizes batch sizes.
    Inputs are float64 tensors on ``device``.
    """

    def __init__(self, table: Optional[optimize.PolicyTable] = None, *,
                 key=None, n_runs: int = 128, max_failures: int = 32,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_cached_programs: int = 8, shard: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if table is None:
            table = optimize.default_policy_table(
                ClusterProfile().scenario(), 14 * 24 * 3600.0)
        self.table = table
        self.key = prng.PRNGKey(0) if key is None else key
        self.n_runs = int(n_runs)
        self.max_failures = int(max_failures)
        self.buckets = tuple(buckets)
        self.shard = bool(shard)
        self._pending: List[ClusterProfile] = []

        def fleet_core(inp, key, makespan, proc):
            return sweep._renewal_fleet_mc_core(
                inp, key, makespan, proc, self.n_runs, self.max_failures)

        self._cache = DispatchCache(fleet_core,
                                    max_entries=max_cached_programs)
        # sharded twin: the same core per device chunk of the cluster axis,
        # the key broadcast, so every chunk draws exactly what the
        # unsharded program draws for its rows
        self._shard_cache = DispatchCache(
            fleet_core, max_entries=max_cached_programs,
            compile=self._split_over_devices)

    def _shard_devices(self) -> list:
        if self.device.type != "cuda":
            return [self.device]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def _split_over_devices(self, core):
        devices = self._shard_devices()

        def program(inp, key, makespan, proc):
            c = inp.interval.shape[0]
            per = c // len(devices)
            parts = [core(_inputs_to(inp, i * per, (i + 1) * per, dev), key,
                          makespan[i * per:(i + 1) * per].to(dev),
                          _process_rows(proc, i * per, (i + 1) * per))
                     for i, dev in enumerate(devices)]
            return {k: torch.cat([p[k].to(self.device) for p in parts])
                    for k in parts[0]}
        return program

    # -- serving surface ----------------------------------------------------

    def submit(self, profile: ClusterProfile) -> int:
        """Queue one request; returns its id (position in the next flush)."""
        self._pending.append(profile)
        return len(self._pending) - 1

    def flush(self) -> List[Advisory]:
        """Answer every pending request: group -> pad -> dispatch ->
        scatter.  Answers come back in submit order; the queue empties."""
        profiles, self._pending = self._pending, []
        if not profiles:
            return []
        groups = group_indices([p.bucket_key() for p in profiles])
        results = {
            bkey: self._dispatch_bucket([profiles[i] for i in idx])
            for bkey, idx in groups.items()
        }
        optima = scatter(groups, results)
        return [Advisory(request_id=i, profile=p, optimum=o)
                for i, (p, o) in enumerate(zip(profiles, optima))]

    def advise(self, profiles: Sequence[ClusterProfile]) -> List[Advisory]:
        """submit + flush in one call (the batch-mode entry point)."""
        for p in profiles:
            self.submit(p)
        return self.flush()

    def cache_stats(self) -> CacheStats:
        """Aggregated program-cache counters (unsharded + sharded paths)."""
        a, b = self._cache.stats(), self._shard_cache.stats()
        return CacheStats(hits=a.hits + b.hits, misses=a.misses + b.misses,
                          evictions=a.evictions + b.evictions,
                          traces=a.traces + b.traces,
                          entries=a.entries + b.entries)

    # -- one bucket ---------------------------------------------------------

    def _dispatch_bucket(self, profiles: List[ClusterProfile]) -> list:
        n_real = len(profiles)
        n_dev = len(self._shard_devices()) if self.shard else 1
        padded = pad_rows(profiles, bucket_size(
            n_real, self.buckets, multiple_of=n_dev))
        specs = [p.spec() for p in padded]
        procs = [s.process for s in specs]
        stacked_proc = failures.stack_processes(procs)
        stacked = optimize.fleet_policy_inputs(
            [s.cfg for s in specs], self.table, self.device)
        makespans = np.stack([
            optimize.wall_makespan(s.work_s, self.table.ckpt_interval,
                                   s.cfg.ckpt_duration)
            for s in specs])                                   # (C, P)
        c = len(specs)
        n_surv = len(specs[0].cfg.survivors)
        bkey = (c, n_surv, padded[0].family, len(self.table),
                self.n_runs, self.max_failures)
        cache = self._shard_cache if self.shard else self._cache
        if self.shard:
            bkey = bkey + ("shard", n_dev)
        out = cache.get(bkey)(
            stacked, self.key,
            torch.as_tensor(makespans, device=self.device), stacked_proc)
        stats = {k: v.cpu().numpy() for k, v in out.items()}
        optima = []
        for ci in range(n_real):
            proc_c = procs[ci]
            res = optimize._policy_eval_from_stats(
                self.table, specs[ci].cfg.name,
                {k: v[ci] for k, v in stats.items()}, makespans[ci],
                specs[ci].work_s, float(np.mean(proc_c.mean_s())),
                proc_c.label(), self.n_runs, self.max_failures)
            optima.append(optimize._optimum_from_grid(res))
        return optima
