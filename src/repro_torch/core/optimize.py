"""Policy grids: which knobs should an operator pick?

Counterpart of the grid half of ``repro.core.optimize``: a flat table of
operator-tunable knobs (checkpoint interval x mu1 x mu2 x wait mode x
move-ahead fraction) evaluated in ONE kernel launch with common random
numbers (one sampling pass shared by every policy lane), compared at equal
useful work (``wall_makespan``), and reduced to a Pareto front of expected
energy vs expected makespan with its knee.  ``cem_refine``,
``optimize_policy``, ``optimize_across_processes`` and the fleet
``clusters=`` axis arrive with the next slice (ROADMAP Queue 1).

Host-side reductions are numpy float64 on the lean per-run statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import failures, sweep
from repro_torch.core.simulator import ScenarioConfig

__all__ = [
    "PolicyTable",
    "PolicyEvalResult",
    "policy_grid",
    "interval_floor",
    "wall_makespan",
    "policy_inputs",
    "evaluate_policy_grid",
    "pareto_front",
    "knee_point",
]


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
    a 1 % margin, as ``policy_inputs`` validates it."""
    return 1.01 * max([s.ckpt_age for s in cfg.survivors]
                      + [cfg.t_reexec, 1.0])


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


# ---------------------------------------------------------------------------
# the grid evaluator: one kernel launch per (grid, key)
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


def _policy_eval_from_stats(
    table: PolicyTable,
    scenario_name: str,
    stats,
    makespans: np.ndarray,
    work_s: Optional[float],
    mtbf: float,
    process_label: str,
    n_runs: int,
    max_failures: int,
) -> PolicyEvalResult:
    """Host-side reduction of device ``RenewalDeviceStats`` (leading policy
    axis) into a ``PolicyEvalResult`` — shared by the single-cluster path
    and each cluster row of the fleet dispatch."""
    f8 = lambda a: np.asarray(a, np.float64)
    energy_ref, energy_int = f8(stats.energy_ref), f8(stats.energy_int)
    saving, end_time = f8(stats.saving), f8(stats.end_time)
    n_failures = np.asarray(stats.n_failures, np.int64)
    truncated = np.asarray(stats.truncated, bool)
    n_points = np.maximum(np.asarray(stats.n_points, np.int64).sum(axis=1), 1)
    rate = lambda c: np.asarray(c, np.int64).sum(axis=1) / n_points
    return PolicyEvalResult(
        table=table,
        scenario=scenario_name,
        work_s=None if work_s is None else float(work_s),
        makespan_s=makespans,
        mtbf_s=mtbf,
        process_label=process_label,
        n_runs=n_runs,
        max_failures=max_failures,
        energy_ref=energy_ref,
        energy_int=energy_int,
        saving=saving,
        end_time=end_time,
        n_failures=n_failures,
        truncated=truncated,
        mean_energy_j=energy_int.mean(axis=1),
        mean_energy_ref_j=energy_ref.mean(axis=1),
        mean_saving_j=saving.mean(axis=1),
        mean_makespan_s=end_time.mean(axis=1),
        mean_failures=n_failures.astype(np.float64).mean(axis=1),
        truncated_rate=truncated.mean(axis=1),
        sleep_occupancy=rate(stats.n_sleep),
        min_freq_rate=rate(stats.n_min_freq),
        infeasible_rate=rate(stats.n_infeasible),
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


def evaluate_policy_grid(cfg: Optional[ScenarioConfig], table: PolicyTable,
                         key, *, work_s: Optional[float] = None,
                         makespan_s: Optional[float] = None,
                         n_runs: int = 128, max_failures: int = 32,
                         mtbf_s: Optional[float] = None,
                         process: Optional[failures.FailureProcess] = None,
                         topology=None, clusters=None, engine: str = "kernel",
                         device="cuda") -> PolicyEvalResult:
    """Expected whole-run energy AND makespan for every policy in one
    kernel launch (sampling shared across policies, composition, Algorithm
    1, whole-run reduction).

    Exactly one of ``work_s`` (equal useful work: per-policy wall makespan
    via ``wall_makespan``) or ``makespan_s`` (equal wall time) is given.
    The failure process is ``process`` or the paper's exponential at
    ``mtbf_s``.  Deterministic for a fixed ``key``; within the port every
    lane is bit-identical to a standalone launch on that policy alone.
    """
    if clusters is not None:
        raise sweep._not_in_slice("the fleet clusters= axis")
    if topology is not None:
        raise sweep._not_in_slice("the correlated topology= sampler")
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
        max_failures=max_failures, process=proc, engine=engine))
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
