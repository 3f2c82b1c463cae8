"""Policy optimisation: which knobs should an operator pick?

Counterpart of ``repro.core.optimize``: a flat table of operator-tunable
knobs (checkpoint interval x mu1 x mu2 x wait mode x move-ahead fraction)
evaluated in one call of the renewal engines (the float64 scan by default,
or the CUDA kernel) with common random numbers (one sampling pass shared by
every policy lane), compared at equal useful work (``wall_makespan``), and
reduced to a Pareto front of expected energy vs expected makespan with its
knee.  On top of the grid evaluator:

  * ``cem_refine`` — a cross-entropy-method loop over the continuous knobs,
    seeded at the grid optimum, with the incumbent re-injected into every
    population so the best-so-far score is monotone under CRN;
  * ``optimize_policy`` / ``optimize_across_processes`` — the operator
    entry points; the latter re-runs the search under exponential, Weibull
    and trace processes at equal MTBF;
  * the fleet ``clusters=`` axis of ``evaluate_policy_grid`` and
    ``optimize_policy`` — one grid for many clusters in one scan over the
    ``(C, P)`` lanes, each cluster's rows bit-identical to a standalone
    call at the same key.

Host-side reductions are numpy float64 on the lean per-run statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import failures, prng, sweep
from repro_torch.core.simulator import ScenarioConfig

__all__ = [
    "PolicyTable",
    "PolicyEvalResult",
    "CEMResult",
    "PolicyOptimum",
    "ClusterSpec",
    "policy_grid",
    "default_policy_table",
    "interval_floor",
    "wall_makespan",
    "policy_inputs",
    "fleet_policy_inputs",
    "evaluate_policy_grid",
    "pareto_front",
    "knee_point",
    "cem_refine",
    "optimize_policy",
    "equal_mtbf_processes",
    "optimize_across_processes",
]

# the continuous knobs cem_refine may search over (wait_mode is discrete:
# fixed per CEM run, covered by the grid stage)
CEM_KNOBS = ("ckpt_interval", "mu1", "mu2", "move_ahead_frac")


# ---------------------------------------------------------------------------
# the policy grid: flat (P,) knob columns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """A flat batch of policies: one row per policy, one column per knob.

    Columns are (P,) numpy arrays (float64 / int32 for ``wait_mode``).
    Build cross products with ``policy_grid``, arbitrary point sets by
    constructing directly.  Rows are the kernel's lane axis.
    """

    ckpt_interval: np.ndarray   # (P,) checkpoint timer interval, wall s
    mu1: np.ndarray             # (P,) sleep-gate time margin (eq. 8)
    mu2: np.ndarray             # (P,) sleep-gate energy margin
    wait_mode: np.ndarray       # (P,) em.WaitMode value
    move_ahead_frac: np.ndarray  # (P,) move-ahead age threshold fraction

    def __post_init__(self):
        cols = {}
        for name in ("ckpt_interval", "mu1", "mu2", "move_ahead_frac"):
            cols[name] = np.atleast_1d(np.asarray(getattr(self, name), np.float64))
        cols["wait_mode"] = np.atleast_1d(np.asarray(self.wait_mode, np.int32))
        p = max(c.shape[0] for c in cols.values())
        for name, c in cols.items():
            if c.shape[0] not in (1, p):
                raise ValueError(
                    f"PolicyTable.{name} has {c.shape[0]} rows, expected 1 or {p}")
            object.__setattr__(self, name, np.broadcast_to(c, (p,)).copy())
        if np.any(self.ckpt_interval <= 0.0):
            raise ValueError("ckpt_interval must be positive")

    def __len__(self) -> int:
        return int(self.ckpt_interval.shape[0])

    def policy(self, p: int) -> dict:
        """Row ``p`` as a knob dict (the ``scenarios.apply_policy`` kwargs)."""
        return {
            "ckpt_interval": float(self.ckpt_interval[p]),
            "mu1": float(self.mu1[p]),
            "mu2": float(self.mu2[p]),
            "wait_mode": int(self.wait_mode[p]),
            "move_ahead_frac": float(self.move_ahead_frac[p]),
        }

    def subset(self, idx) -> "PolicyTable":
        idx = np.asarray(idx)
        return PolicyTable(
            ckpt_interval=self.ckpt_interval[idx],
            mu1=self.mu1[idx],
            mu2=self.mu2[idx],
            wait_mode=self.wait_mode[idx],
            move_ahead_frac=self.move_ahead_frac[idx],
        )


def policy_grid(
    *,
    ckpt_interval,
    mu1=6.0,
    mu2=1.0,
    wait_mode=em.WaitMode.ACTIVE,
    move_ahead_frac=0.5,
) -> PolicyTable:
    """Cross product of candidate values per knob, flattened to a
    ``PolicyTable``.

    Each argument is a scalar or a 1-D sequence of candidates; the row
    order is C-order over (interval, mu1, mu2, wait_mode, move_ahead_frac)
    — deterministic, so grid row ``p`` always means the same policy.
    """
    axes = [
        np.atleast_1d(np.asarray(ckpt_interval, np.float64)),
        np.atleast_1d(np.asarray(mu1, np.float64)),
        np.atleast_1d(np.asarray(mu2, np.float64)),
        np.atleast_1d(np.asarray([int(w) for w in np.atleast_1d(wait_mode)],
                                 np.int32)),
        np.atleast_1d(np.asarray(move_ahead_frac, np.float64)),
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    return PolicyTable(
        ckpt_interval=mesh[0].reshape(-1),
        mu1=mesh[1].reshape(-1),
        mu2=mesh[2].reshape(-1),
        wait_mode=mesh[3].reshape(-1).astype(np.int32),
        move_ahead_frac=mesh[4].reshape(-1),
    )


def interval_floor(cfg: ScenarioConfig) -> float:
    """The smallest searchable checkpoint interval for ``cfg``: the
    sawtooth precondition (no overdue timer at the start — ``sweep_inputs``
    rejects intervals below any starting ``ckpt_age`` / ``t_reexec``) with
    a 1 % margin: what ``policy_inputs`` validates, ``default_policy_table``
    floors its grid at and ``cem_refine`` clips its box to."""
    return 1.01 * max([s.ckpt_age for s in cfg.survivors]
                      + [cfg.t_reexec, 1.0])


def default_policy_table(cfg: ScenarioConfig, mtbf_s: float) -> PolicyTable:
    """A sensible operator grid around the Young anchor: intervals
    ``sqrt(2 * t_ckpt * mtbf)`` x geomspace(0.25, 4, 7), floored at
    ``interval_floor``; mu1 {3.8, 6, 9} (the Table-4 band plus one value
    outside it); both wait modes."""
    young = float(np.sqrt(2.0 * cfg.ckpt_duration * mtbf_s))
    lo = interval_floor(cfg)
    intervals = np.unique(np.maximum(young * np.geomspace(0.25, 4.0, 7), lo))
    return policy_grid(
        ckpt_interval=intervals,
        mu1=[3.8, 6.0, 9.0],
        mu2=[1.0],
        wait_mode=[em.WaitMode.ACTIVE, em.WaitMode.IDLE],
        move_ahead_frac=[0.5],
    )


def wall_makespan(work_s, ckpt_interval_s, ckpt_duration_s):
    """Wall length of a failure-free balanced run that completes ``work_s``
    fa-seconds of useful work under a timer-checkpoint policy.

    The timer fires after every ``interval`` of execution (age 0 start), so
    completing ``W`` takes ``W + n * dur`` wall seconds with ``n`` the
    fires *strictly inside* the work span (a checkpoint landing exactly at
    completion is not taken).  Inverse of ``planning.balanced_span``:
    ``balanced_span(0, wall_makespan(W, T, d), T, d)[0] == W`` exactly
    (property-tested).  This is what makes checkpoint intervals comparable:
    every policy runs the *same application*, and pays its own checkpoint
    overhead in wall time — which the makespan objective then sees.
    """
    work = np.asarray(work_s, np.float64)
    interval = np.asarray(ckpt_interval_s, np.float64)
    dur = np.asarray(ckpt_duration_s, np.float64)
    n = np.maximum(np.ceil(work / interval) - 1.0, 0.0)
    return work + n * dur


def _check_grid(cfg: ScenarioConfig, table: PolicyTable) -> None:
    """Shared grid preconditions: the renewal-config checks plus the
    interval floor over the table's shortest interval."""
    sweep._check_renewal_config(cfg)
    t_min = float(np.min(table.ckpt_interval))
    if t_min < interval_floor(cfg):
        raise ValueError(
            f"{cfg.name}: grid interval {t_min} below the searchable floor "
            f"{interval_floor(cfg):.1f} (starting ckpt_age/t_reexec + 1% — "
            "see interval_floor); start the search from a balanced snapshot "
            "(scenarios.post_recovery_config) or raise the interval floor")



def policy_inputs(cfg: ScenarioConfig, table: PolicyTable,
                  device="cuda") -> sweep.SweepInputs:
    """Stack ONE scenario into per-policy float64 ``SweepInputs`` (leading
    policy axis): non-knob leaves broadcast, knob leaves replaced by the
    table's columns — per lane exactly ``sweep.sweep_inputs(
    scenarios.apply_policy(cfg, **table.policy(p)), float64)``."""
    _check_grid(cfg, table)
    dev = resolve_device(device)
    n_policies = len(table)
    base = sweep.sweep_inputs(cfg, torch.float64, dev)
    bc = lambda a: a.expand((n_policies,) + tuple(a.shape))
    f8 = lambda c: torch.as_tensor(np.asarray(c, np.float64), device=dev)
    return sweep.SweepInputs(
        exec_rem0=bc(base.exec_rem0), period=bc(base.period),
        age0=bc(base.age0), reexec0=bc(base.reexec0),
        t_down=bc(base.t_down), t_restart=bc(base.t_restart),
        interval=f8(table.ckpt_interval), dur=bc(base.dur),
        move_ahead=bc(base.move_ahead), move_frac=f8(table.move_ahead_frac),
        wait_mode=torch.as_tensor(table.wait_mode, dtype=torch.int32,
                                  device=dev),
        mu1=f8(table.mu1), mu2=f8(table.mu2),
        p_idle_wait=bc(base.p_idle_wait),
        ladder=em.LadderArrays(**{f: bc(getattr(base.ladder, f))
                                  for f in sweep._LADDER}),
        sleep=em.SleepArrays(**{f: bc(getattr(base.sleep, f))
                                for f in sweep._SLEEP}),
        peer=base.peer)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One fleet member: a cluster's scenario plus its failure law.

    ``process=None`` falls back to the call-level ``process``/``mtbf_s``;
    ``work_s`` (optional) overrides the call-level useful work for this
    cluster.  ``repro_torch.fleet.ClusterProfile.spec()`` builds these;
    ``evaluate_policy_grid``/``optimize_policy`` also accept bare
    ``(cfg, process)`` tuples and bare configs.
    """

    cfg: ScenarioConfig
    process: Optional[failures.FailureProcess] = None
    work_s: Optional[float] = None


def _as_cluster_spec(c) -> ClusterSpec:
    if isinstance(c, ClusterSpec):
        return c
    if isinstance(c, ScenarioConfig):
        return ClusterSpec(c)
    cfg, proc = c
    return ClusterSpec(cfg, proc)


def _np_policy_inputs(cfg: ScenarioConfig, table: PolicyTable) -> sweep.SweepInputs:
    """Host-numpy twin of ``policy_inputs``: ``SweepInputs`` of numpy
    arrays holding the same float64 values, no device traffic.  The fleet
    stacker calls this once per cluster and ships each stacked leaf in one
    transfer."""
    _check_grid(cfg, table)
    n_policies = len(table)
    f8 = lambda x: np.asarray(x, np.float64)
    bc = lambda a: np.broadcast_to(f8(a), (n_policies,) + np.shape(f8(a)))
    pt, sl = cfg.profile.power_table, cfg.profile.sleep
    return sweep.SweepInputs(
        exec_rem0=bc([s.exec_to_rendezvous for s in cfg.survivors]),
        period=bc([s.rendezvous_period for s in cfg.survivors]),
        age0=bc([s.ckpt_age for s in cfg.survivors]),
        reexec0=bc(cfg.t_reexec),
        t_down=bc(cfg.t_down),
        t_restart=bc(cfg.t_restart),
        interval=f8(table.ckpt_interval),
        dur=bc(cfg.ckpt_duration),
        move_ahead=np.broadcast_to(np.asarray(bool(cfg.move_ahead)),
                                   (n_policies,)),
        move_frac=f8(table.move_ahead_frac),
        wait_mode=np.asarray(table.wait_mode, np.int32),
        mu1=f8(table.mu1),
        mu2=f8(table.mu2),
        p_idle_wait=bc(cfg.profile.p_idle_wait),
        ladder=em.LadderArrays(**{f: bc(getattr(pt, f))
                                  for f in sweep._LADDER}),
        sleep=em.SleepArrays(**{f: bc(getattr(sl, f)) for f in sweep._SLEEP}),
        peer=tuple(s.peer for s in cfg.survivors),
    )


def fleet_policy_inputs(cfgs: Sequence[ScenarioConfig], table: PolicyTable,
                        device="cuda") -> sweep.SweepInputs:
    """Stack MANY scenarios x one policy table into ``(C, P)`` float64
    ``SweepInputs`` on ``device``: each cluster's slice carries exactly the
    values ``policy_inputs(cfg_c, table)`` builds, assembled on the host
    and shipped in one transfer per leaf.  The clusters must share survivor
    count, ladder size and blocking topology — the static-shape bucket key
    the fleet advisor groups requests by."""
    dev = resolve_device(device)
    cfg_list = list(cfgs)
    if not cfg_list:
        raise ValueError("no clusters to stack")
    per = [_np_policy_inputs(cfg, table) for cfg in cfg_list]
    shapes = {p.exec_rem0.shape for p in per}
    ladders = {p.ladder.freq_ghz.shape for p in per}
    peers = {p.peer for p in per}
    if len(shapes) != 1 or len(ladders) != 1 or len(peers) != 1:
        raise ValueError(
            "fleet clusters must share survivor count, ladder size, and "
            f"blocking topology (got {shapes}, {ladders}, {peers}); "
            "group heterogeneous node counts into shape buckets "
            "(repro_torch.fleet.FleetAdvisor)")
    return sweep._map_leaves(
        lambda xs: torch.as_tensor(np.stack(xs), device=dev), per)


# ---------------------------------------------------------------------------
# the grid evaluator: one engine call per (grid, key)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyEvalResult:
    """Per-policy whole-run expectations for one scenario x one PRNG key.

    Per-run arrays are (P, R) host float64 — every policy saw the *same* R
    failure histories (CRN), so row-wise differences are paired.  Means and
    rates are (P,).  ``makespan_s`` is each policy's wall-makespan *input*
    (equal work); ``mean_makespan_s`` the realized expectation including
    recovery epochs.
    """

    table: PolicyTable
    scenario: str
    work_s: Optional[float]
    makespan_s: np.ndarray      # (P,) input wall makespan per policy
    mtbf_s: float
    process_label: str
    n_runs: int
    max_failures: int
    # per-run outputs, (P, R)
    energy_ref: np.ndarray
    energy_int: np.ndarray
    saving: np.ndarray
    end_time: np.ndarray
    n_failures: np.ndarray
    truncated: np.ndarray
    # per-policy expectations, (P,)
    mean_energy_j: np.ndarray       # E[whole-run intervened energy]
    mean_energy_ref_j: np.ndarray
    mean_saving_j: np.ndarray
    mean_makespan_s: np.ndarray     # E[realized wall end]
    mean_failures: np.ndarray
    truncated_rate: np.ndarray
    sleep_occupancy: np.ndarray
    min_freq_rate: np.ndarray
    infeasible_rate: np.ndarray

    def __len__(self) -> int:
        return len(self.table)

    @property
    def best(self) -> int:
        """Index of the minimum expected-energy policy (ties: first)."""
        return int(np.argmin(self.mean_energy_j))

    def policy(self, p: int) -> dict:
        """Row ``p``'s knobs plus its objectives."""
        return dict(
            self.table.policy(p),
            mean_energy_j=float(self.mean_energy_j[p]),
            mean_makespan_s=float(self.mean_makespan_s[p]),
            mean_saving_j=float(self.mean_saving_j[p]),
        )


def _policy_eval_from_stats(table: PolicyTable, scenario_name: str,
                            stats: dict, makespans: np.ndarray,
                            work_s: Optional[float], mtbf: float,
                            process_label: str, n_runs: int,
                            max_failures: int) -> PolicyEvalResult:
    """Host-side reduction of the lean stats (leading policy axis)."""
    f8 = lambda a: np.asarray(a, np.float64)
    energy_ref, energy_int = f8(stats["energy_ref"]), f8(stats["energy_int"])
    saving, end_time = f8(stats["saving"]), f8(stats["end_time"])
    n_failures = np.asarray(stats["n_failures"], np.int64)
    truncated = np.asarray(stats["truncated"], bool)
    n_points = np.maximum(np.asarray(stats["n_points"], np.int64).sum(axis=1), 1)
    rate = lambda c: np.asarray(c, np.int64).sum(axis=1) / n_points
    return PolicyEvalResult(
        table=table, scenario=scenario_name,
        work_s=None if work_s is None else float(work_s),
        makespan_s=makespans, mtbf_s=mtbf, process_label=process_label,
        n_runs=n_runs, max_failures=max_failures,
        energy_ref=energy_ref, energy_int=energy_int, saving=saving,
        end_time=end_time, n_failures=n_failures, truncated=truncated,
        mean_energy_j=energy_int.mean(axis=1),
        mean_energy_ref_j=energy_ref.mean(axis=1),
        mean_saving_j=saving.mean(axis=1),
        mean_makespan_s=end_time.mean(axis=1),
        mean_failures=n_failures.astype(np.float64).mean(axis=1),
        truncated_rate=truncated.mean(axis=1),
        sleep_occupancy=rate(stats["n_sleep"]),
        min_freq_rate=rate(stats["n_min_freq"]),
        infeasible_rate=rate(stats["n_infeasible"]),
    )


def _evaluate_policy_grid_fleet(clusters, table: PolicyTable, key, *, work_s,
                                makespan_s, n_runs: int, max_failures: int,
                                mtbf_s, process, engine: str,
                                device) -> list:
    """The ``clusters=`` arm of ``evaluate_policy_grid``: one ``(C, P)``
    scan, split back into per-cluster results."""
    specs = [_as_cluster_spec(c) for c in clusters]
    procs = [failures.as_process(
        s.process if s.process is not None else process, mtbf_s)
        for s in specs]
    stacked_proc = failures.stack_processes(procs)
    if (work_s is None) == (makespan_s is None):
        raise ValueError("give exactly one of work_s or makespan_s")
    works, rows = [], []
    for s in specs:
        if work_s is not None:
            w = float(work_s if s.work_s is None else s.work_s)
            rows.append(wall_makespan(w, table.ckpt_interval,
                                      s.cfg.ckpt_duration))
            works.append(w)
        else:
            if s.work_s is not None:
                raise ValueError(
                    "per-cluster work_s overrides need the work_s calling "
                    "convention, not makespan_s")
            rows.append(np.full(len(table), float(makespan_s), np.float64))
            works.append(None)
    makespans = np.stack(rows)                              # (C, P)
    stacked = fleet_policy_inputs([s.cfg for s in specs], table, device)
    stats = sweep._stats_to_host(sweep.renewal_monte_carlo_policies(
        stacked, key, makespan_s=makespans, n_runs=n_runs,
        max_failures=max_failures, process=stacked_proc, stats=True,
        engine=engine))
    return [_policy_eval_from_stats(
        table, s.cfg.name, {k: v[c] for k, v in stats.items()}, makespans[c],
        works[c], float(np.mean(proc_c.mean_s())), proc_c.label(), n_runs,
        max_failures)
        for c, (s, proc_c) in enumerate(zip(specs, procs))]


def evaluate_policy_grid(cfg: Optional[ScenarioConfig], table: PolicyTable,
                         key, *, work_s: Optional[float] = None,
                         makespan_s: Optional[float] = None,
                         n_runs: int = 128, max_failures: int = 32,
                         mtbf_s: Optional[float] = None,
                         process: Optional[failures.FailureProcess] = None,
                         topology=None, clusters=None, engine: str = "scan",
                         device="cuda") -> PolicyEvalResult:
    """Expected whole-run energy AND makespan for every policy in one call
    (sampling shared across policies, composition, Algorithm 1, whole-run
    reduction): ``engine="scan"`` (default) is the float64 scan,
    ``engine="kernel"`` one launch of the float32 CUDA kernel.

    Exactly one of ``work_s`` (equal useful work: per-policy wall makespan
    via ``wall_makespan``) or ``makespan_s`` (equal wall time) is given.
    The failure process is ``process`` or the paper's exponential at
    ``mtbf_s``; a ``core.topology.Topology`` swaps in the correlated shock
    sampler, whose histories and felled sets every policy lane shares
    (common random numbers).  Deterministic for a fixed ``key``; within the
    port every lane is bit-identical to a standalone call on that policy
    alone.

    ``clusters=`` (with ``cfg=None``) evaluates the same grid for a fleet
    in one ``(C, P)`` scan: a sequence of ``ClusterSpec`` / ``(cfg,
    process)`` pairs / configs sharing survivor count and ladder size and
    one process family, each cluster sampling its own histories at the same
    key.  Returns a LIST of per-cluster results, each bit-identical to a
    standalone call on that cluster; scan engine only, no topology.
    """
    if clusters is not None:
        if cfg is not None:
            raise ValueError(
                "pass cfg=None with clusters=: each ClusterSpec carries "
                "its own scenario")
        if topology is not None:
            raise ValueError(
                "cluster-stacked dispatch samples iid per cluster; "
                "correlated topologies are a single-cluster feature")
        return _evaluate_policy_grid_fleet(
            clusters, table, key, work_s=work_s, makespan_s=makespan_s,
            n_runs=n_runs, max_failures=max_failures, mtbf_s=mtbf_s,
            process=process, engine=engine, device=device)
    if (work_s is None) == (makespan_s is None):
        raise ValueError("give exactly one of work_s or makespan_s")
    proc = failures.as_process(process, mtbf_s)
    mtbf = float(np.mean(proc.mean_s()))
    if work_s is not None:
        makespans = wall_makespan(float(work_s), table.ckpt_interval,
                                  cfg.ckpt_duration)
    else:
        makespans = np.full(len(table), float(makespan_s), np.float64)
    stacked = policy_inputs(cfg, table, device)
    stats = sweep._stats_to_host(sweep.renewal_monte_carlo_policies(
        stacked, key, makespan_s=makespans, n_runs=n_runs,
        max_failures=max_failures, process=proc, topology=topology,
        engine=engine))
    return _policy_eval_from_stats(
        table, cfg.name, stats, makespans, work_s, mtbf, proc.label(),
        n_runs, max_failures)


# ---------------------------------------------------------------------------
# Pareto frontier (energy vs makespan) and the knee
# ---------------------------------------------------------------------------

def pareto_front(energy, makespan) -> np.ndarray:
    """Indices of the non-dominated (energy, makespan) points, both axes
    minimized, sorted energy-ascending.

    Point ``j`` dominates ``i`` when it is <= on both objectives and < on
    at least one; exact duplicates of a kept point are dropped (they are
    mutually non-dominated — keeping one representative keeps the front a
    function of energy).  O(n log n).
    """
    energy = np.asarray(energy, np.float64)
    makespan = np.asarray(makespan, np.float64)
    if energy.shape != makespan.shape or energy.ndim != 1:
        raise ValueError("energy and makespan must be equal-length 1-D arrays")
    order = np.lexsort((makespan, energy))      # energy asc, ties makespan asc
    front, best_makespan = [], np.inf
    for i in order:
        if makespan[i] < best_makespan:
            front.append(int(i))
            best_makespan = makespan[i]
    return np.asarray(front, np.int64)


def knee_point(energy, makespan, front: Optional[np.ndarray] = None) -> int:
    """The frontier's knee: the point of maximum perpendicular distance to
    the chord between the frontier's two extreme points (max-distance-to-
    chord, the 'kneedle' construction) after min-max normalizing both
    objectives so joules and seconds are commensurable.

    Degenerate frontiers (fewer than three points, or collinear) fall back
    to the normalized utopia distance ``argmin ||(e_n, m_n)||`` — for a
    single-point front that is the point itself.  Returns an index into the
    *original* arrays.
    """
    energy = np.asarray(energy, np.float64)
    makespan = np.asarray(makespan, np.float64)
    if front is None:
        front = pareto_front(energy, makespan)
    e, m = energy[front], makespan[front]
    e_n = (e - e.min()) / max(np.ptp(e), 1e-300)
    m_n = (m - m.min()) / max(np.ptp(m), 1e-300)
    if front.size >= 3:
        # cross product distance to the chord (first -> last frontier point)
        de, dm = e_n[-1] - e_n[0], m_n[-1] - m_n[0]
        dist = np.abs(de * (m_n - m_n[0]) - dm * (e_n - e_n[0]))
        if dist.max() > 1e-12:
            return int(front[int(np.argmax(dist))])
    return int(front[int(np.argmin(np.hypot(e_n, m_n)))])


# ---------------------------------------------------------------------------
# cross-entropy refinement of the continuous knobs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CEMResult:
    """Outcome of ``cem_refine``: the refined policy and the schedule it
    followed.  ``iterations`` rows carry the per-iteration sampling mean /
    std per knob and the iteration's best score; ``best`` is the incumbent
    after the last iteration — never worse than the seed under CRN."""

    best: dict                  # knobs + mean_energy_j / mean_makespan_s
    seed_policy: dict
    iterations: tuple           # per-iteration dicts
    n_evaluations: int


def cem_refine(cfg: ScenarioConfig, key, *, init: dict, bounds: dict,
               work_s: Optional[float] = None,
               makespan_s: Optional[float] = None, n_iters: int = 5,
               population: int = 24, elite_frac: float = 0.25,
               smoothing: float = 0.7, init_std_frac: float = 0.25,
               makespan_weight: float = 0.0, n_runs: int = 128,
               max_failures: int = 32, mtbf_s: Optional[float] = None,
               process: Optional[failures.FailureProcess] = None,
               topology=None, seed: int = 0,
               warm: Optional["CEMResult"] = None,
               device="cuda") -> CEMResult:
    """Cross-entropy refinement of the continuous knobs around a seed.

    ``init`` is a full policy dict (a ``PolicyEvalResult.policy`` row,
    typically the grid optimum); ``bounds`` maps a subset of ``CEM_KNOBS``
    to (lo, hi) boxes — knobs without bounds stay at ``init``, and
    ``wait_mode`` is always fixed.  Each iteration samples a Gaussian
    population (numpy ``default_rng(seed)``, so the same seed draws the
    reference's population), clips it to the bounds, appends the incumbent,
    evaluates the whole population in ONE scan call under the SAME ``key``
    (CRN: the incumbent re-scores identically), then moves mean/std toward
    the elite fraction with exponential ``smoothing``.  Score =
    ``mean_energy_j + makespan_weight * mean_makespan_s``; the reported best
    never regresses.  The interval box is floored at ``interval_floor``.

    ``warm`` resumes the Gaussian from a previous ``CEMResult``: mean/std
    start at its last posterior (clipped to the current bounds, std floored
    at 2 % of each box); the incumbent re-injection still uses ``init``.
    """
    missing = [k for k in bounds if k not in CEM_KNOBS]
    if missing:
        raise ValueError(f"not continuous CEM knobs: {missing} "
                         f"(allowed: {CEM_KNOBS})")
    if not bounds:
        raise ValueError("bounds must name at least one knob to refine")
    if "ckpt_interval" in bounds:
        # a Gaussian draw below the sawtooth floor would otherwise abort
        # the refinement mid-loop via policy_inputs' ValueError
        lo, hi = bounds["ckpt_interval"]
        floor = interval_floor(cfg)
        if hi <= floor:
            raise ValueError(
                f"ckpt_interval bounds ({lo}, {hi}) lie below the scenario's "
                f"starting ckpt_age/t_reexec floor {floor:.1f}")
        bounds = dict(bounds, ckpt_interval=(max(lo, floor), hi))
    knobs = tuple(k for k in CEM_KNOBS if k in bounds)
    mean = {k: float(init[k]) for k in knobs}
    std = {k: init_std_frac * (bounds[k][1] - bounds[k][0]) for k in knobs}
    if warm is not None and warm.iterations:
        prev = warm.iterations[-1]
        for k in knobs:
            if k in prev["mean"]:
                lo, hi = bounds[k]
                mean[k] = float(np.clip(prev["mean"][k], lo, hi))
                std[k] = max(float(prev["std"][k]), 0.02 * (hi - lo))
    rng = np.random.default_rng(seed)
    eval_kw = dict(work_s=work_s, makespan_s=makespan_s, n_runs=n_runs,
                   max_failures=max_failures, mtbf_s=mtbf_s, process=process,
                   topology=topology, device=device)

    score_of = lambda res: res.mean_energy_j + makespan_weight * res.mean_makespan_s
    incumbent = dict(init)
    best_score = None
    history = []
    n_evals = 0
    for _ in range(n_iters):
        cols = {}
        for k in CEM_KNOBS:
            if k in knobs:
                lo, hi = bounds[k]
                draw = mean[k] + std[k] * rng.standard_normal(population)
                cols[k] = np.append(np.clip(draw, lo, hi), incumbent[k])
            else:
                cols[k] = np.full(population + 1, float(init[k]))
        tab = PolicyTable(wait_mode=np.full(population + 1,
                                            int(init["wait_mode"]), np.int32),
                          **cols)
        res = evaluate_policy_grid(cfg, tab, key, **eval_kw)
        n_evals += len(tab)
        score = score_of(res)
        order = np.argsort(score, kind="stable")
        n_elite = max(2, int(round(elite_frac * len(tab))))
        elite = order[:n_elite]
        for k in knobs:
            col = cols[k]
            mean[k] = smoothing * float(col[elite].mean()) \
                + (1.0 - smoothing) * mean[k]
            std[k] = smoothing * float(col[elite].std()) \
                + (1.0 - smoothing) * std[k]
        b = int(order[0])
        # CRN: the incumbent row re-scores bit-identically, so score[b] <=
        # the incumbent's score by construction — best-so-far is monotone
        if best_score is None or score[b] <= best_score:
            best_score = float(score[b])
            incumbent = res.policy(b)
        history.append({
            "mean": dict(mean), "std": dict(std),
            "best_score": float(score[b]),
            "best_energy_j": float(res.mean_energy_j[b]),
            "best_makespan_s": float(res.mean_makespan_s[b]),
        })
    return CEMResult(best=incumbent, seed_policy=dict(init),
                     iterations=tuple(history), n_evaluations=n_evals)


# ---------------------------------------------------------------------------
# operator entry points
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyOptimum:
    """One scenario x one failure process, optimized: ``best`` is the
    minimum-expected-energy policy (CEM-refined when ``refine=True``, else
    the grid argmin), ``pareto`` indexes the grid's non-dominated (energy,
    makespan) set energy-ascending, ``knee`` is the frontier's knee policy
    and ``grid`` the full evaluation."""

    scenario: str
    process_label: str
    mtbf_s: float
    grid: PolicyEvalResult
    best: dict
    pareto: np.ndarray
    knee: dict
    cem: Optional[CEMResult]


def _optimum_from_grid(res: PolicyEvalResult) -> PolicyOptimum:
    """Fold a grid evaluation into its ``PolicyOptimum`` (argmin + Pareto
    frontier + knee), without a CEM stage."""
    front = pareto_front(res.mean_energy_j, res.mean_makespan_s)
    knee = res.policy(knee_point(res.mean_energy_j, res.mean_makespan_s,
                                 front))
    return PolicyOptimum(scenario=res.scenario,
                         process_label=res.process_label, mtbf_s=res.mtbf_s,
                         grid=res, best=res.policy(res.best), pareto=front,
                         knee=knee, cem=None)


def optimize_policy(cfg: Optional[ScenarioConfig], key=None, *,
                    table: Optional[PolicyTable] = None,
                    work_s: float = 30 * 24 * 3600.0,
                    mtbf_s: Optional[float] = None,
                    process: Optional[failures.FailureProcess] = None,
                    n_runs: int = 128, max_failures: int = 32,
                    refine: bool = False, cem_kw: Optional[dict] = None,
                    topology=None, clusters=None, engine: str = "scan",
                    device="cuda"):
    """Tune the policy knobs for one scenario under one failure process.

    Evaluates ``table`` (default: ``default_policy_table`` around the Young
    anchor) at equal useful work ``work_s`` in one engine call, extracts
    the energy/makespan Pareto frontier and its knee, and (``refine=True``)
    runs ``cem_refine`` on the continuous knobs seeded at the grid argmin,
    its bounds by default the grid's own knob ranges.  ``key`` defaults to
    ``prng.PRNGKey(0)``; ``process=None`` is the paper's exponential at
    per-node ``mtbf_s`` (default 14 days).  ``engine="kernel"`` runs the
    grid stage as one launch of the CUDA kernel; the CEM stage stays on the
    scan, as in the reference.

    ``clusters=`` (``cfg=None``) tunes a whole fleet in one ``(C, P)``
    scan and returns a LIST of per-cluster ``PolicyOptimum`` bit-identical
    to standalone calls per cluster at the same key.  The table is shared
    (default: ``default_policy_table`` of the first cluster at its process
    MTBF); ``refine=True`` is a single-cluster feature and raises.
    """
    if key is None:
        key = prng.PRNGKey(0)
    if clusters is not None:
        if cfg is not None:
            raise ValueError("pass cfg=None with clusters=: each "
                             "ClusterSpec carries its own scenario")
        if refine:
            raise ValueError(
                "refine=True is a single-cluster feature; CEM-refine the "
                "per-cluster grid optima individually if needed")
        specs = [_as_cluster_spec(c) for c in clusters]
        if not specs:
            raise ValueError("no clusters to optimize")
        if table is None:
            p0 = failures.as_process(
                specs[0].process if specs[0].process is not None else process,
                14 * 24 * 3600.0 if mtbf_s is None else mtbf_s)
            table = default_policy_table(specs[0].cfg,
                                         float(np.mean(p0.mean_s())))
        results = evaluate_policy_grid(
            None, table, key, work_s=work_s, n_runs=n_runs,
            max_failures=max_failures, mtbf_s=mtbf_s, process=process,
            topology=topology, clusters=specs, engine=engine, device=device)
        return [_optimum_from_grid(res) for res in results]
    proc = failures.as_process(process, 14 * 24 * 3600.0 if mtbf_s is None
                               else mtbf_s)
    if table is None:
        table = default_policy_table(cfg, float(np.mean(proc.mean_s())))
    res = evaluate_policy_grid(
        cfg, table, key, work_s=work_s, n_runs=n_runs,
        max_failures=max_failures, process=proc, topology=topology,
        engine=engine, device=device)
    opt = _optimum_from_grid(res)
    if not refine:
        return opt
    kw = dict(cem_kw or {})
    bounds = kw.pop("bounds", None)
    if bounds is None:
        span = lambda c: (float(np.min(c)), float(np.max(c)))
        bounds = {"ckpt_interval": span(table.ckpt_interval),
                  "mu1": span(table.mu1)}
        bounds = {k: v for k, v in bounds.items() if v[0] < v[1]}
        if not bounds:
            bounds = {"ckpt_interval": (0.5 * opt.best["ckpt_interval"],
                                        2.0 * opt.best["ckpt_interval"])}
    cem_args = dict(work_s=work_s, n_runs=n_runs, max_failures=max_failures,
                    process=proc, topology=topology, device=device)
    cem_args.update(kw)     # cem_kw overrides the grid-stage defaults
    cem = cem_refine(cfg, key, init=opt.best, bounds=bounds, **cem_args)
    return dataclasses.replace(opt, best=cem.best, cem=cem)


def equal_mtbf_processes(mtbf_s: float, *, weibull_k: float = 0.7,
                         trace_n: int = 512, trace_seed: int = 0) -> dict:
    """The standard process panel at equal per-node MTBF: the paper's
    exponential, an infant-mortality Weibull, and an empirical trace
    (Weibull-shaped numpy draws from ``trace_seed`` rescaled to the exact
    MTBF)."""
    raw = np.random.default_rng(trace_seed).weibull(weibull_k, trace_n)
    gaps = raw * (mtbf_s / raw.mean())
    return {
        "exponential": failures.Exponential(mtbf_s),
        f"weibull_k{weibull_k:g}": failures.Weibull.from_mtbf(weibull_k, mtbf_s),
        "trace": failures.EmpiricalTrace(gaps),
    }


def optimize_across_processes(cfg: ScenarioConfig, key=None, *,
                              mtbf_s: float,
                              processes: Optional[dict] = None,
                              **kw) -> dict:
    """name -> ``PolicyOptimum`` across failure processes at equal MTBF:
    same key, same grid, same work for every process, so the raw uniforms
    behind the gap sampler are shared and only the inter-failure law moves
    between entries.  ``kw`` goes to ``optimize_policy`` (``device``
    included)."""
    if key is None:
        key = prng.PRNGKey(0)
    if processes is None:
        processes = equal_mtbf_processes(mtbf_s)
    return {name: optimize_policy(cfg, key, process=proc, mtbf_s=mtbf_s, **kw)
            for name, proc in processes.items()}
