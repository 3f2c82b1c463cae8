"""Online adaptive energy controller: observe -> fit -> retune -> apply,
the counterpart of ``repro.ft.controller``.

Closes the loop between the training runtime (ft/runtime.py) and the
planning stack (core/sweep.py, core/optimize.py, core/failures.py):

  * ``StochasticFailureInjector`` drives ``FTTrainer`` with the *same*
    failure histories the renewal engine samples — one run sliced out of
    ``sweep.renewal_failure_gaps`` at a shared PRNG key, so the live run is
    run ``run_index`` of the engine's Monte Carlo;
  * ``AdaptiveController`` watches realized inter-failure gaps from inside
    the trainer, keeps per-node failure-clock ages (competing risks: each
    failure yields one *complete* lifetime for the failed node, every other
    node's open age is a right-censored observation), refits the process
    online (``failures.fit_weibull`` with censoring) and re-runs
    ``optimize.cem_refine`` — warm-started from the previous posterior — to
    retune ``ckpt_interval`` / ``mu1`` / ``mu2`` / ``wait_mode``, which the
    trainer pushes into the live ``ClusterSpec`` and checkpoint cadences;
  * ``reconcile_ledger`` checks the trainer's realized energy ledger
    against the renewal engine: exactly (``renewal_compose`` on the
    realized gap sequence; relative error ~1e-5) and in expectation
    (``renewal_monte_carlo_device`` at the injector's key; the trainer
    quantizes failure instants to step boundaries, so that tolerance
    depends on the step size).

Keys are the port's ``core.prng`` keys (numpy ``uint32[2]``).  The engines
are the reference's defaults: the float64 scan for
``evaluate_policy_grid``, ``cem_refine`` and ``renewal_monte_carlo_device``,
on ``device``.

The geometry mapping (``cluster_scenario``) is exact for the synchronous
data-parallel trainer: every survivor has one full step of execution to its
next rendezvous (period = step time), checkpoint clocks re-anchor at zero
after each coordinated resync, and the failed node's lost work is the
engine's re-execution sawtooth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import failures, optimize, prng, sweep
from repro_torch.core.simulator import NodeStart, ScenarioConfig

__all__ = [
    "cluster_scenario",
    "StochasticFailureInjector",
    "RetuneRecord",
    "AdaptiveController",
    "ReconcileReport",
    "reconcile_ledger",
]


def cluster_scenario(cluster, *, ckpt_duration_s: float = 120.0,
                     ckpt_interval_s: Optional[float] = None,
                     name: str = "cluster") -> ScenarioConfig:
    """Map a live ``ClusterSpec`` onto the renewal engine's geometry.

    Synchronous DP at a step boundary: ``n_pods - 1`` survivors, each with
    exactly one step of execution to its next rendezvous (period = step
    time) and a zero checkpoint-clock age at the anchor (the coordinated
    resync checkpoint); the failed node re-executes from its own sawtooth
    (``t_reexec = 0`` at the anchor).  Policy knobs come from the spec.
    """
    if cluster.n_pods < 2:
        raise ValueError(f"need >= 2 pods for a survivor scenario, "
                         f"got {cluster.n_pods}")
    dt = float(cluster.step_time_s)
    interval = float(cluster.ckpt_interval_s if ckpt_interval_s is None
                     else ckpt_interval_s)
    survivors = tuple(
        NodeStart(exec_to_rendezvous=dt, rendezvous_period=dt, ckpt_age=0.0)
        for _ in range(cluster.n_pods - 1))
    return ScenarioConfig(
        name=name,
        survivors=survivors,
        t_down=float(cluster.t_down_s),
        t_restart=float(cluster.t_restart_s),
        t_reexec=0.0,
        profile=cluster.profile,
        ckpt_interval=interval,
        ckpt_duration=float(ckpt_duration_s),
        wait_mode=cluster.wait_mode,
        move_ahead=cluster.move_ahead,
        move_ahead_frac=cluster.move_ahead_frac,
        mu1=float(cluster.mu1),
        mu2=float(cluster.mu2),
    )


class StochasticFailureInjector:
    """Failure schedule drawn from a ``FailureProcess`` renewal sampler.

    Samples the ``(n_runs, max_failures)`` gap/failed-node history that
    ``renewal_monte_carlo_device`` samples at ``key`` (on ``device``) and
    replays run ``run_index`` against the trainer's balanced wall clock:
    the next failure fires at the first pre-step boundary whose upcoming
    step would cross the sampled gap.  Gaps are balanced time since the
    last renewal anchor — the engine's renewal semantics.

    With a ``core.topology.Topology`` the schedule is the correlated shock
    history instead, and a multi-node shock epoch is replayed as a *burst*:
    the primary fires with the sampled gap, then every co-felled node fires
    with a zero gap at the same boundary — the trainer's pre-step drain
    loop handles the consecutive failures, and the zero gaps are the
    clustering signature ``AdaptiveController``'s burst detector keys on.
    """

    def __init__(self, process, key, *, n_pods: int, max_failures: int = 64,
                 n_runs: int = 1, run_index: int = 0, topology=None,
                 device="cuda"):
        if not 0 <= run_index < n_runs:
            raise ValueError(f"run_index {run_index} outside n_runs {n_runs}")
        self.process = process
        self.key = key
        self.n_pods = int(n_pods)
        self.n_runs = int(n_runs)
        self.run_index = int(run_index)
        self.max_failures = int(max_failures)
        self.topology = topology
        dev = resolve_device(device)
        if topology is None:
            gaps, failed = sweep.renewal_failure_gaps(
                key, n_runs, n_pods, max_failures, process=process, device=dev)
            self.gaps = gaps[run_index].cpu().numpy().astype(np.float64)
            self.failed_node = failed[run_index].cpu().numpy().astype(np.int64)
        else:
            gaps, primary, fmask = sweep.renewal_failure_gaps(
                key, n_runs, n_pods, max_failures, process=process,
                topology=topology, device=dev)
            gaps, primary = gaps.cpu().numpy(), primary.cpu().numpy()
            fmask = fmask.cpu().numpy()
            flat_g, flat_n = [], []
            for k in range(gaps.shape[1]):
                p = int(primary[run_index, k])
                flat_g.append(float(gaps[run_index, k]))
                flat_n.append(p)
                for i in np.nonzero(fmask[run_index, k])[0]:
                    if int(i) != p:
                        flat_g.append(0.0)
                        flat_n.append(int(i))
            self.gaps = np.asarray(flat_g, np.float64)
            self.failed_node = np.asarray(flat_n, np.int64)
        self._i = 0

    @property
    def n_fired(self) -> int:
        return self._i

    def check(self, step: int) -> Optional[int]:
        return None

    def poll(self, step: int, balanced_since_anchor_s: float,
             step_time_s: float) -> Optional[int]:
        if self._i >= self.gaps.shape[0]:
            return None
        if self.gaps[self._i] < balanced_since_anchor_s + step_time_s:
            return int(self.failed_node[self._i])
        return None

    def confirm(self, step: int) -> None:
        self._i += 1


@dataclasses.dataclass(frozen=True)
class RetuneRecord:
    """One controller retune: what it had observed, what it fitted, what it
    chose, and what the optimization cost in wall time."""

    step: int
    n_observed: int
    process_label: str
    policy: dict
    score_j: float
    wall_s: float


class AdaptiveController:
    """Observe realized failures, refit the process, retune the policy.

    Runs inside ``FTTrainer`` (``controller=`` argument): the trainer calls
    ``observe_failure`` after every recovery and ``maybe_retune`` to ask
    for a new policy, which it then pushes into the live ``ClusterSpec``
    and checkpoint cadences.

    Failure-clock bookkeeping mirrors ``failures.failure_clock_ages``: all
    node clocks advance by each renewal gap, the failed node's clock
    resets.  Each failure therefore contributes one *complete* lifetime
    (the failed node's age) and the other nodes' open ages at fitting time
    are right-censored observations — together the per-node Weibull
    likelihood under competing risks (``fit_weibull(..., censored=...)``).

    Retunes warm-start ``cem_refine`` from the previous posterior and use a
    fixed PRNG key (CRN), so successive retunes refine rather than restart
    the search.  ``wait_mode`` (discrete) is retuned by a two-row grid
    evaluation at the incumbent knobs before the continuous CEM stage.  The
    engines run on ``device``.

    Graceful degradation (``degrade=True``): every observed gap leaves a
    PIT residual — ``u = 1 - prod_i S(a_i + g) / S(a_i)``, the fitted (or
    prior) model's probability of an epoch gap <= the realized one given
    the clock ages — which is Uniform(0, 1) exactly when the declared
    renewal model holds.  Correlated bursts violate it recognisably (mass
    collapses onto u ~ 0: co-felled nodes replay as zero gaps), so a window
    whose residuals fail a KS check against uniform, or whose raw gaps pile
    up at zero, marks the process *misfit*.  While misfit the controller
    refuses to refit or retune on the poisoned window and instead applies
    ``conservative_policy`` once (or keeps the incumbent when None); after
    ``hysteresis`` consecutive calm checks it re-engages adaptation.
    ``degrade_events`` records every transition.
    """

    def __init__(self, prior_process, *, n_pods: int, retune_every: int = 1,
                 min_complete_gaps: int = 3, k_bounds=(0.3, 5.0),
                 mu1_bounds=(2.0, 12.0), cem_iters: int = 2,
                 cem_population: int = 12, cem_n_runs: int = 48,
                 cem_max_failures: int = 32, search_wait_mode: bool = True,
                 seed: int = 0, degrade: bool = False,
                 conservative_policy: Optional[dict] = None,
                 burst_window: int = 8, burst_alpha: float = 0.01,
                 near_zero_s: float = 1.0, near_zero_frac: float = 0.25,
                 hysteresis: int = 2, device="cuda"):
        self.prior_process = prior_process
        self.n_pods = int(n_pods)
        self.retune_every = int(retune_every)
        self.min_complete_gaps = int(min_complete_gaps)
        self.k_bounds = (float(k_bounds[0]), float(k_bounds[1]))
        self.mu1_bounds = (float(mu1_bounds[0]), float(mu1_bounds[1]))
        self.cem_iters = int(cem_iters)
        self.cem_population = int(cem_population)
        self.cem_n_runs = int(cem_n_runs)
        self.cem_max_failures = int(cem_max_failures)
        self.search_wait_mode = bool(search_wait_mode)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._key = prng.PRNGKey(seed)
        self._ages = np.zeros(self.n_pods)      # per-node failure-clock ages
        self.complete_gaps: List[float] = []    # failed-node lifetimes
        self.n_failures = 0
        self.fitted: Optional[failures.FailureProcess] = None
        self.retunes: List[RetuneRecord] = []
        self._warm = None                       # previous CEMResult
        self.degrade = bool(degrade)
        self.conservative_policy = (dict(conservative_policy)
                                    if conservative_policy else None)
        self.burst_window = int(burst_window)
        self.burst_alpha = float(burst_alpha)
        self.near_zero_s = float(near_zero_s)
        self.near_zero_frac = float(near_zero_frac)
        self.hysteresis = int(hysteresis)
        self.pit: List[float] = []              # model-PIT residual per gap
        self._gap_log: List[float] = []
        self.degraded = False
        self._calm_streak = 0
        self.degrade_events: List[dict] = []

    # --- observe ------------------------------------------------------------

    def _pit_residual(self, gap_s: float) -> float:
        """Model probability of an epoch gap <= ``gap_s`` given the current
        clock ages: ``1 - prod_i S(a_i + g) / S(a_i)`` under the fitted (or
        prior) process — exactly Uniform(0, 1) when the model holds."""
        proc = self.fitted or self.prior_process
        a = np.asarray(self._ages, np.float64)
        s1 = np.asarray(proc.survival(a + float(gap_s)), np.float64)
        s0 = np.maximum(np.asarray(proc.survival(a), np.float64), 1e-300)
        return float(1.0 - np.prod(np.minimum(s1 / s0, 1.0)))

    def observe_failure(self, *, gap_s: float, failed_pod: int) -> None:
        """One renewal epoch: every clock aged by the gap, the failed
        node's age is a complete lifetime and its clock restarts.  The
        PIT residual is taken against the pre-update ages (the model's
        view of this gap before it happened)."""
        self.pit.append(self._pit_residual(gap_s))
        self._gap_log.append(float(gap_s))
        self._ages += float(gap_s)
        self.complete_gaps.append(float(self._ages[failed_pod]))
        self._ages[failed_pod] = 0.0
        self.n_failures += 1

    def burst_active(self) -> bool:
        """Misfit detector over the last ``burst_window`` observations:
        raw gaps piling up at zero (the correlated-burst signature — see
        ``StochasticFailureInjector``'s burst replay) or PIT residuals
        failing a KS test against Uniform(0, 1)."""
        if len(self.pit) < self.burst_window:
            return False
        g = np.asarray(self._gap_log[-self.burst_window:], np.float64)
        if float(np.mean(g <= self.near_zero_s)) >= self.near_zero_frac:
            return True
        u = np.asarray(self.pit[-self.burst_window:], np.float64)
        ks = failures.ks_statistic(u, lambda x: np.clip(x, 0.0, 1.0))
        return bool(ks > failures.ks_critical(u.size, alpha=self.burst_alpha))

    # --- fit ----------------------------------------------------------------

    def fit(self) -> Optional[failures.FailureProcess]:
        """Censored Weibull MLE over everything observed so far; None until
        ``min_complete_gaps`` *positive* complete lifetimes have
        accumulated (a lifetime quantized to zero — a node re-failing
        within the same step boundary — carries no shape information and is
        excluded, matching ``fit_weibull``'s positive filter)."""
        gaps = np.asarray(self.complete_gaps, np.float64)
        pos = gaps[gaps > 0.0]
        if pos.size < self.min_complete_gaps:
            return None
        censored = self._ages[self._ages > 0.0]
        k, scale = failures.fit_weibull(pos, censored=censored)
        k_c = float(np.clip(k, *self.k_bounds))
        if k_c != k:
            # re-solve the scale at the clipped shape (same MLE expression)
            t = np.concatenate([pos, censored])
            scale = float((np.sum(t ** k_c) / pos.size) ** (1.0 / k_c))
        self.fitted = failures.Weibull(k=k_c, scale_s=scale)
        return self.fitted

    # --- retune -------------------------------------------------------------

    def maybe_retune(self, *, trainer, remaining_work_s: Optional[float],
                     step: int) -> Optional[dict]:
        """Refit and re-optimize after a failure; returns the new policy
        dict (``FTTrainer._apply_policy`` kwargs) or None to keep the
        incumbent."""
        if self.n_failures % self.retune_every != 0:
            return None
        dt = float(trainer.cluster.step_time_s)
        if remaining_work_s is not None and remaining_work_s < 2.0 * dt:
            return None     # nothing left to amortize a policy change over
        if self.degrade:
            if self.burst_active():
                self._calm_streak = 0
                if not self.degraded:
                    self.degraded = True
                    self.degrade_events.append(
                        {"step": int(step), "action": "degrade"})
                    if self.conservative_policy is not None:
                        return dict(self.conservative_policy)
                return None  # conservative hold: no refit on a poisoned window
            if self.degraded:
                self._calm_streak += 1
                if self._calm_streak < self.hysteresis:
                    return None
                self.degraded = False
                self._calm_streak = 0
                self.degrade_events.append(
                    {"step": int(step), "action": "re-engage"})
        process = self.fit() or self.prior_process
        mean_s = float(np.mean(np.asarray(process.mean_s(), np.float64)))
        work_s = float(remaining_work_s) if remaining_work_s is not None \
            else 8.0 * mean_s

        t0 = time.perf_counter()
        cluster = trainer.cluster
        cfg = cluster_scenario(cluster, ckpt_duration_s=trainer.ckpt_duration_s)
        init = {"ckpt_interval": float(cluster.ckpt_interval_s),
                "mu1": float(cluster.mu1), "mu2": float(cluster.mu2),
                "move_ahead_frac": float(cluster.move_ahead_frac),
                "wait_mode": int(cluster.wait_mode)}

        wait_mode = int(cluster.wait_mode)
        if self.search_wait_mode:
            table = optimize.PolicyTable(
                ckpt_interval=np.full(2, init["ckpt_interval"]),
                mu1=np.full(2, init["mu1"]), mu2=np.full(2, init["mu2"]),
                wait_mode=np.asarray([int(em.WaitMode.ACTIVE),
                                      int(em.WaitMode.IDLE)], np.int32),
                move_ahead_frac=np.full(2, init["move_ahead_frac"]))
            grid = optimize.evaluate_policy_grid(
                cfg, table, self._key, work_s=work_s, n_runs=self.cem_n_runs,
                max_failures=self.cem_max_failures, process=process,
                device=self.device)
            wait_mode = int(table.wait_mode[grid.best])
            cfg = dataclasses.replace(cfg, wait_mode=em.WaitMode(wait_mode))
            init["wait_mode"] = wait_mode

        # interval box around the fitted process's Young point, floored at
        # both the engine's sawtooth precondition and one step
        young = float(np.sqrt(2.0 * mean_s * cfg.ckpt_duration))
        lo = max(optimize.interval_floor(cfg), dt, 0.25 * young)
        hi = max(4.0 * young, 2.0 * init["ckpt_interval"], 2.0 * lo)
        bounds = {"ckpt_interval": (lo, hi), "mu1": self.mu1_bounds}
        init["ckpt_interval"] = float(np.clip(init["ckpt_interval"], lo, hi))

        res = optimize.cem_refine(
            cfg, self._key, init=init, bounds=bounds, work_s=work_s,
            n_iters=self.cem_iters, population=self.cem_population,
            n_runs=self.cem_n_runs, max_failures=self.cem_max_failures,
            process=process, seed=self.seed, warm=self._warm,
            device=self.device)
        self._warm = res
        wall = time.perf_counter() - t0

        policy = {k: float(res.best[k]) for k in optimize.CEM_KNOBS}
        policy["wait_mode"] = wait_mode
        self.retunes.append(RetuneRecord(
            step=int(step), n_observed=len(self.complete_gaps),
            process_label=process.label(), policy=dict(policy),
            score_j=float(res.best.get("mean_energy_j", np.nan)),
            wall_s=wall))
        return policy


# ---------------------------------------------------------------------------
# ledger-vs-renewal reconciliation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReconcileReport:
    """Cross-engine check of one realized training run.

    ``compose_j`` re-runs the host renewal oracle on the *realized* gap
    sequence — same geometry, same float32 Algorithm-1 — so
    ``rel_err_compose`` isolates accounting drift (expected ~1e-5).
    ``mc_j`` is the renewal Monte Carlo's prediction for the injector's run
    at the shared key; the trainer quantizes failure instants to step
    boundaries, so ``rel_err_mc`` is bounded by the step-time share of the
    inter-failure gaps (a documented tolerance, not a bug indicator).
    """

    ledger_j: float
    compose_j: float
    rel_err_compose: float
    mc_j: Optional[float]
    rel_err_mc: Optional[float]
    n_failures: int
    makespan_s: float


def reconcile_ledger(trainer, *, injector: Optional[StochasticFailureInjector]
                     = None, mc: bool = True, device="cuda") -> ReconcileReport:
    """Reconcile a finished trainer's energy ledger against the renewal
    engine (on ``device``).  Assumes the policy was constant over the run
    (reconcile static runs; adaptive runs change the geometry mid-flight)."""
    dev = resolve_device(device)
    gaps = [e["gap_s"] for e in trainer.events if e["kind"] == "failure"]
    makespan_s = float(trainer.sim_balanced_s)
    cfg = cluster_scenario(trainer.cluster,
                           ckpt_duration_s=trainer.ckpt_duration_s)
    # pad with an overlong gap so the oracle sees exactly the realized
    # failures and then the balanced tail to the makespan
    padded = np.asarray(gaps + [2.0 * makespan_s + 1.0], np.float64)[None, :]
    res = sweep.renewal_compose(cfg, padded, makespan_s, device=dev)
    compose_j = float(res.energy_int[0])
    ledger_j = float(trainer.energy.ledger_total_j())
    rel = abs(ledger_j - compose_j) / max(abs(compose_j), 1e-9)

    mc_j = rel_mc = None
    if injector is None and isinstance(trainer.injector,
                                       StochasticFailureInjector):
        injector = trainer.injector
    if mc and injector is not None:
        device_res = sweep.renewal_monte_carlo_device(
            [cfg], injector.key, n_runs=injector.n_runs,
            makespan_s=makespan_s, max_failures=injector.max_failures,
            process=injector.process, device=dev)
        mc_j = float(np.asarray(device_res.energy_int.cpu())[0,
                                                             injector.run_index])
        rel_mc = abs(ledger_j - mc_j) / max(abs(mc_j), 1e-9)
    return ReconcileReport(
        ledger_j=ledger_j, compose_j=compose_j, rel_err_compose=rel,
        mc_j=mc_j, rel_err_mc=rel_mc, n_failures=len(gaps),
        makespan_s=makespan_s)
