"""Energy-aware fault-tolerance runtime: the paper's technique as a
training-framework feature, the counterpart of ``repro.ft.runtime``.

Pieces:
  * ``ClusterSpec``     — virtual multi-pod cluster (pod count, telemetry,
                          machine power profile);
  * ``FailureInjector`` — deterministic failure schedule {step: pod};
  * ``EnergyManager``   — bridges runtime telemetry to the paper's
                          Algorithm 1 (``core.strategies``, on the manager's
                          device) at failure time and integrates the energy
                          ledger;
  * ``ElasticPlan``     — elastic shrink/regrow of the DeviceMesh when a
                          pod is lost, and the reshard onto it;
  * ``FTTrainer``       — orchestration loop: synchronous data-parallel
                          steps, uncoordinated pod-local checkpoints (with
                          move-ahead), failure -> localized rollback ->
                          deterministic re-execution -> rejoin, straggler
                          mitigation via the same strategy engine.

Physical power actions (DVFS/S3) are not exercised: the runtime drives a
simulated power ledger with the characterization tables of the paper; the
decision path is the one a real agent would execute.

The trainer keeps its initial state and restored states by reference, as
the reference does: that is safe because a train step
(``launch.steps.make_train_step``) is functional and never updates a
tensor it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointConfig, PodCheckpointManager
from repro_torch.core import energy_model as em
from repro_torch.core import planning, strategies
from repro_torch.core.characterization import MachineProfile, paper_machine_profile
from repro_torch.parallel.sharding import mesh_axes

__all__ = ["ClusterSpec", "FailureInjector", "EnergyManager", "EnergyEvent",
           "ElasticPlan", "FTTrainer"]

@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    n_pods: int = 4
    step_time_s: float = 10.0            # synchronous step wall time
    t_down_s: float = 60.0
    t_restart_s: float = 60.0
    profile: MachineProfile = dataclasses.field(default_factory=paper_machine_profile)
    wait_mode: em.WaitMode = em.WaitMode.ACTIVE
    mu1: float = 6.0
    mu2: float = 1.0
    # checkpoint policy knobs mirrored from the live cadence: FTTrainer
    # keeps ckpt_interval_s synced to the managers' interval_steps *
    # step_time_s so the move-ahead predictor prices the actual cadence,
    # and the adaptive controller retunes all three at runtime
    # (ft/controller.py).
    ckpt_interval_s: float = 3600.0
    move_ahead: bool = True
    move_ahead_frac: float = 0.5


class FailureInjector:
    def __init__(self, schedule: Optional[Dict[int, int]] = None):
        self.schedule = dict(schedule or {})

    def check(self, step: int) -> Optional[int]:
        return self.schedule.get(step)

    def poll(self, step: int, balanced_since_anchor_s: float,
             step_time_s: float) -> Optional[int]:
        """Failure check at the pre-step boundary.  The base injector keys
        on the step index alone; stochastic injectors (ft/controller.py)
        key on the balanced wall clock instead."""
        del balanced_since_anchor_s, step_time_s
        return self.check(step)

    def confirm(self, step: int) -> None:
        """The trainer handled the failure just polled at ``step``."""
        self.schedule.pop(step, None)


@dataclasses.dataclass
class EnergyEvent:
    """Energy ledger entry for one failure (or straggler) event."""

    step: int
    failed_pod: int
    reexec_steps: int
    decisions: dict                 # pod -> {freq_ghz, wait_action, ...}
    saving_j: float
    reference_j: float
    saving_pct: float
    intervention_s: float
    # renewal-epoch accounting (failure events only; stragglers leave 0):
    # the epoch's total energy under the chosen interventions / under the
    # no-intervention reference, in the renewal engine's own decomposition
    # (survivor windows + trailing fa spans to T_E + the failed node).
    # gap_s is the balanced wall time since the previous renewal anchor;
    # progress_frac the survivor fractions the decision saw.
    epoch_int_j: float = 0.0
    epoch_ref_j: float = 0.0
    gap_s: float = 0.0
    t_e_s: float = 0.0
    progress_frac: tuple = ()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EnergyManager:
    """Evaluates the paper's strategies when the runtime loses a pod.  The
    checkpoint plan is the host float64 closed form (as the reference runs
    it on numpy inputs); Algorithm 1 runs in float32 on ``device``."""

    def __init__(self, cluster: ClusterSpec, device="cuda"):
        self.cluster = cluster
        self.device = resolve_device(device)
        self.events: List[EnergyEvent] = []
        # steady-state ledger: balanced step compute, timer-checkpoint
        # writes, post-recovery resync checkpoints.  Epoch (failure-window)
        # energy lives on the events; the total realized run energy is
        # ledger_total_j().
        self.steps_j = 0.0
        self.ckpt_j = 0.0
        self.resync_j = 0.0

    # --- steady-state ledger ------------------------------------------------

    def note_steps(self, n: int = 1) -> None:
        """n synchronous steps: every pod computes at the reference level."""
        c = self.cluster
        p_comp0 = float(c.profile.power_table.p_comp[0])
        self.steps_j += n * c.n_pods * c.step_time_s * p_comp0

    def note_checkpoints(self, n_saved: int, ckpt_duration_s: float) -> None:
        """n_saved timer-checkpoint writes at the reference level."""
        p_ckpt0 = float(self.cluster.profile.power_table.p_ckpt[0])
        self.ckpt_j += n_saved * ckpt_duration_s * p_ckpt0

    def note_resync(self, ckpt_duration_s: float) -> None:
        """Coordinated post-recovery resync: all pods write one checkpoint
        (the renewal engine's ``n_nodes * dur_fa * p_ckpt0`` term)."""
        pt = self.cluster.profile.power_table
        dur_fa = ckpt_duration_s * float(pt.gamma[0])
        self.resync_j += self.cluster.n_pods * dur_fa * float(pt.p_ckpt[0])

    def ledger_total_j(self) -> float:
        """Realized whole-run energy under the chosen interventions —
        directly comparable to ``renewal_compose(...).energy_int``."""
        return self.steps_j + self.ckpt_j + self.resync_j + sum(
            e.epoch_int_j for e in self.events)

    def ledger_reference_j(self) -> float:
        """Same run without interventions (``energy_ref`` analog)."""
        return self.steps_j + self.ckpt_j + self.resync_j + sum(
            e.epoch_ref_j for e in self.events)

    def on_failure(self, *, step: int, failed_pod: int, reexec_steps: int,
                   ckpt_ages_s: np.ndarray, ckpt_duration_s: float,
                   progress_frac: np.ndarray, gap_s: float = 0.0) -> EnergyEvent:
        """Run Algorithm 1 for every surviving pod.

        progress_frac[i]: fraction of the current step pod i still has to
        execute before blocking on the failed pod's collective (the alpha of
        paper eq. 14); ckpt_ages_s feeds the move-ahead predictor, which
        prices the actual cadence (cluster.ckpt_interval_s) through the
        shared ``planning.checkpoint_plan``.
        """
        c = self.cluster
        pt = c.profile.power_table
        p_comp0, p_ckpt0 = float(pt.p_comp[0]), float(pt.p_ckpt[0])
        beta0, gamma0 = float(pt.beta[0]), float(pt.gamma[0])
        survivors = [p for p in range(c.n_pods) if p != failed_pod]
        t_comp = np.array([progress_frac[p] * c.step_time_s for p in survivors])
        t_recover = c.t_down_s + c.t_restart_s + reexec_steps * c.step_time_s
        t_failed = t_recover + t_comp                           # eq (14)/(15)
        interval = float(c.ckpt_interval_s)
        ages = np.array([ckpt_ages_s[p] for p in survivors], np.float64)

        f8 = lambda x: torch.as_tensor(np.asarray(x, np.float64))
        plan = planning.checkpoint_plan(
            f8(t_comp), f8(ages), f8(t_failed), interval=interval,
            dur=ckpt_duration_s, beta=f8(pt.beta), gamma=f8(pt.gamma),
            move_ahead=c.move_ahead, move_frac=c.move_ahead_frac)
        move = _np(plan.plan_move)
        n_ckpt = _np(plan.n_ckpt)                               # (n, levels)

        d = strategies.evaluate_strategies_profile(
            c.profile, t_comp, t_failed, n_ckpt, ckpt_duration_s,
            np.full(len(survivors), int(c.wait_mode)), mu1=c.mu1, mu2=c.mu2,
            per_level_n_ckpt=True, device=self.device)
        d = {f.name: _np(getattr(d, f.name)) for f in dataclasses.fields(d)}

        # renewal-epoch accounting, mirroring sweep.renewal_compose: each
        # survivor's window energy plus the trailing reference-level span to
        # the renewal point T_E, plus the failed node over [failure, T_E].
        p_star = float(np.max(t_comp))
        t_e = t_recover + p_star
        epoch_failed = c.t_restart_s * p_ckpt0 \
            + (reexec_steps * c.step_time_s + p_star) * p_comp0
        ct_ref = t_comp * beta0 + n_ckpt[:, 0] * ckpt_duration_s * gamma0
        eni = np.asarray(d["energy_reference"], np.float64)
        ei = np.asarray(d["energy_intervened"], np.float64)
        ct_sel = np.asarray(d["comp_time"], np.float64)
        trail_ref = np.maximum(t_e - np.maximum(t_failed, ct_ref), 0.0) * p_comp0
        trail_int = np.maximum(t_e - np.maximum(t_failed, ct_sel), 0.0) * p_comp0

        decisions = {}
        for i, pod in enumerate(survivors):
            decisions[pod] = {
                "freq_ghz": float(d["freq_ghz"][i]),
                "comp_changed": bool(d["comp_changed"][i]),
                "wait_action": em.WaitAction(int(d["wait_action"][i])).name,
                "move_ahead_ckpt": bool(move[i]),
                "predicted_saving_j": float(d["saving"][i]),
                "wait_s": float(d["wait_time"][i]),
            }
        saving = float(np.sum(d["saving"]))
        reference = float(np.sum(d["energy_reference"]))
        event = EnergyEvent(
            step=step,
            failed_pod=failed_pod,
            reexec_steps=reexec_steps,
            decisions=decisions,
            saving_j=saving,
            reference_j=reference,
            saving_pct=100.0 * saving / max(reference, 1e-9),
            intervention_s=float(np.max(t_failed)),
            epoch_int_j=float(np.sum(ei + trail_int) + epoch_failed),
            epoch_ref_j=float(np.sum(eni + trail_ref) + epoch_failed),
            gap_s=float(gap_s),
            t_e_s=float(t_e),
            progress_frac=tuple(float(progress_frac[p]) for p in survivors),
        )
        self.events.append(event)
        return event

    def on_straggler(self, *, step: int, slow_pod: int, delay_s: float,
                     progress_frac: np.ndarray) -> EnergyEvent:
        """Straggler mitigation: the paper's wait-phase logic, with the
        straggler's ETA playing the role of T_failed (beyond-paper use)."""
        c = self.cluster
        waiters = [p for p in range(c.n_pods) if p != slow_pod]
        t_comp = np.array([progress_frac[p] * c.step_time_s for p in waiters])
        t_failed = t_comp + delay_s
        d = strategies.evaluate_strategies_profile(
            c.profile, t_comp, t_failed, np.zeros(len(waiters)), 120.0,
            np.full(len(waiters), int(c.wait_mode)), mu1=c.mu1, mu2=c.mu2,
            device=self.device)
        d = {f.name: _np(getattr(d, f.name)) for f in dataclasses.fields(d)}
        decisions = {
            pod: {
                "freq_ghz": float(d["freq_ghz"][i]),
                "wait_action": em.WaitAction(int(d["wait_action"][i])).name,
                "predicted_saving_j": float(d["saving"][i]),
            }
            for i, pod in enumerate(waiters)
        }
        saving = float(np.sum(d["saving"]))
        reference = float(np.sum(d["energy_reference"]))
        event = EnergyEvent(step=step, failed_pod=slow_pod, reexec_steps=0,
                            decisions=decisions, saving_j=saving,
                            reference_j=reference,
                            saving_pct=100.0 * saving / max(reference, 1e-9),
                            intervention_s=delay_s)
        self.events.append(event)
        return event


@dataclasses.dataclass
class ElasticPlan:
    """Shrink/regrow plan when a pod is lost and spares are unavailable.

    At production scale the 'pod' mesh axis shrinks by one and the training
    state (replicated per pod, see parallel/sharding.py) is re-laid-out on
    the surviving ranks.  ``shrink`` takes a mapping of axis sizes, a
    ``DeviceMesh`` or any object whose ``shape`` maps axes to sizes;
    ``new_mesh`` builds the shrunk ``DeviceMesh`` over the first ranks of
    the default process group, and ``apply`` moves the state onto it."""

    old_axes: dict
    new_axes: dict

    @classmethod
    def shrink(cls, mesh, axis: str = "pod") -> "ElasticPlan":
        axes = dict(mesh) if isinstance(mesh, dict) else mesh_axes(mesh)
        if axes.get(axis, 1) <= 1:
            raise ValueError("cannot shrink a 1-pod mesh; use spare pods")
        new = dict(axes)
        new[axis] = axes[axis] - 1
        return cls(old_axes=axes, new_axes=new)

    def new_mesh(self, device_type: str = "cuda"):
        """The shrunk ``DeviceMesh`` of ``new_axes`` over the first
        ``prod(new_axes)`` ranks of the default process group; every rank
        of the group calls it (the others get no coordinate on it)."""
        from repro_torch.launch.mesh import mesh_over

        return mesh_over(tuple(self.new_axes.values()), tuple(self.new_axes),
                         device_type)

    def apply(self, state, spec_tree, device_type: str = "cuda"):
        """``(mesh, state)``: ``new_mesh`` and every leaf of ``state`` laid
        out on it by the congruent partition spec of ``spec_tree``.  A
        DTensor cannot be redistributed across meshes, so each leaf is
        gathered whole on the old mesh (``full_tensor``, every rank of it
        takes part) and distributed again; a plain leaf is distributed as
        it is."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.parallel.dtensor_ops import is_dtensor
        from repro_torch.parallel.sharding import named_tree

        mesh = self.new_mesh(device_type)

        def move(leaf, sharding):
            whole = leaf.full_tensor() if is_dtensor(leaf) else leaf
            return distribute_tensor(whole, mesh, sharding.placements)

        return mesh, tree_map(move, state, named_tree(mesh, spec_tree))


class FTTrainer:
    """Synchronous-DP training loop with the full FT/energy stack.

    Runs a *virtual cluster*: one step advances the (logically replicated)
    global state; per-pod checkpoint managers snapshot on uncoordinated
    cadences; failures trigger pod-local rollback + deterministic
    re-execution, with Algorithm-1 energy decisions (on ``device``) for the
    survivors.
    """

    def __init__(self, *, step_fn: Callable, pipeline, state, cluster: ClusterSpec,
                 ckpt_cfg: CheckpointConfig, injector: FailureInjector,
                 ckpt_duration_s: float = 120.0, rng: int = 0,
                 controller=None, resync_on_recovery: bool = True,
                 progress_mode: str = "boundary", device="cuda"):
        if progress_mode not in ("boundary", "keyed"):
            raise ValueError(f"unknown progress_mode {progress_mode!r}")
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.state = state              # (params, opt_state)
        # keep the move-ahead predictor's interval synced to the actual
        # checkpoint cadence
        self.cluster = dataclasses.replace(
            cluster,
            ckpt_interval_s=ckpt_cfg.interval_steps * cluster.step_time_s)
        self.injector = injector
        self.device = resolve_device(device)
        self.energy = EnergyManager(self.cluster, self.device)
        self.ckpt_duration_s = ckpt_duration_s
        self.managers = [PodCheckpointManager(ckpt_cfg, p)
                         for p in range(cluster.n_pods)]
        self.controller = controller
        self.resync_on_recovery = resync_on_recovery
        self.progress_mode = progress_mode
        self._seed = rng
        self.rng = np.random.default_rng(rng)
        self._initial_state = tree_map(lambda x: x, state)
        self.history: List[dict] = []
        self.events: List[dict] = []
        self._sim_ckpt_age = np.zeros(cluster.n_pods)   # seconds, simulated
        # balanced wall clock (work + checkpoint writes): total, and since
        # the last renewal anchor — the realized inter-failure gap
        self.sim_balanced_s = 0.0
        self._bal_since_anchor = 0.0

    def _advance(self, step: int):
        batch = self.pipeline.batch_at(step)
        params, opt_state = self.state
        params, opt_state, metrics = self.step_fn(params, opt_state, batch)
        self.state = (params, opt_state)
        return metrics

    def _progress_at(self, step: int) -> np.ndarray:
        """Survivor progress fractions at a failure boundary — a pure
        function of (seed, step) so replaying the same injector schedule
        reproduces the ledger bit-for-bit.  'boundary' pins every pod at a
        full step of remaining execution (the renewal engine's synchronous
        rendezvous geometry); 'keyed' draws from a per-step keyed stream,
        recorded in the event."""
        if self.progress_mode == "boundary":
            return np.ones(self.cluster.n_pods)
        return np.random.default_rng((self._seed, step)).uniform(
            0.0, 1.0, self.cluster.n_pods)

    def run(self, num_steps: int, start_step: int = 0) -> List[dict]:
        step = start_step
        end_step = start_step + num_steps
        while step < end_step:
            # pre-step boundary: drain every failure due now (a stochastic
            # injector may fire again immediately after recovery)
            while True:
                failed = self.injector.poll(step, self._bal_since_anchor,
                                            self.cluster.step_time_s)
                if failed is None:
                    break
                self._handle_failure(step, failed, end_step=end_step)
                self.injector.confirm(step)
            metrics = self._advance(step)
            self.history.append({"step": step,
                                 "loss": float(metrics["total_loss"])})
            # clocks advance before the cadence check so a pod saving at
            # this boundary enters the next step at age 0 (the renewal
            # engine's sawtooth phase)
            dt = self.cluster.step_time_s
            self._sim_ckpt_age += dt
            self.sim_balanced_s += dt
            self._bal_since_anchor += dt
            self.energy.note_steps(1)
            # uncoordinated pod-local checkpoints
            n_saved = 0
            for pod, mgr in enumerate(self.managers):
                if mgr.maybe_save(step, self.state):
                    self._sim_ckpt_age[pod] = 0.0
                    n_saved += 1
            if n_saved:
                self.energy.note_checkpoints(n_saved, self.ckpt_duration_s)
                # synchronized cadences write concurrently: the balanced
                # wall advances one checkpoint duration
                self.sim_balanced_s += self.ckpt_duration_s
                self._bal_since_anchor += self.ckpt_duration_s
            step += 1
        for mgr in self.managers:
            mgr.wait()
        return self.history

    def _apply_policy(self, policy: dict) -> dict:
        """Push a retuned policy into the live cluster spec and checkpoint
        cadences.  The continuous interval snaps to whole steps (>= 1) and
        the spec mirrors the snapped value so predictor and cadence agree."""
        dt = self.cluster.step_time_s
        interval_steps = max(1, int(round(float(policy["ckpt_interval"]) / dt)))
        self.cluster = dataclasses.replace(
            self.cluster,
            ckpt_interval_s=interval_steps * dt,
            mu1=float(policy.get("mu1", self.cluster.mu1)),
            mu2=float(policy.get("mu2", self.cluster.mu2)),
            move_ahead_frac=float(policy.get("move_ahead_frac",
                                             self.cluster.move_ahead_frac)),
            wait_mode=em.WaitMode(int(policy.get("wait_mode",
                                                 int(self.cluster.wait_mode)))),
        )
        self.energy.cluster = self.cluster
        for mgr in self.managers:
            mgr.set_interval_steps(interval_steps)
        return {"interval_steps": interval_steps,
                "ckpt_interval_s": self.cluster.ckpt_interval_s,
                "mu1": self.cluster.mu1, "mu2": self.cluster.mu2,
                "move_ahead_frac": self.cluster.move_ahead_frac,
                "wait_mode": int(self.cluster.wait_mode)}

    def _handle_failure(self, step: int, failed_pod: int,
                        end_step: Optional[int] = None):
        gap_s = self._bal_since_anchor
        mgr = self.managers[failed_pod]
        ckpt_step = mgr.latest_step()
        if ckpt_step is None:
            # no checkpoint yet: cold restart from the initial state
            ckpt_step = -1
            restored = self._initial_state
        else:
            ckpt_step, restored = mgr.restore(self.state)
        # checkpoints snapshot the post-step state: replay [ckpt_step+1, step)
        reexec = step - 1 - ckpt_step

        # survivors: energy strategy decisions (paper Algorithm 1)
        progress = self._progress_at(step)
        event = self.energy.on_failure(
            step=step, failed_pod=failed_pod, reexec_steps=reexec,
            ckpt_ages_s=self._sim_ckpt_age, ckpt_duration_s=self.ckpt_duration_s,
            progress_frac=progress, gap_s=gap_s)
        # move-ahead checkpoints for survivors that chose one: the live
        # state is the post-step state of step-1, so that's the label (a
        # later rollback must never see a checkpoint "from the future");
        # its energy is part of the epoch window (Algorithm 1), not ckpt_j.
        for pod, d in event.decisions.items():
            if d["move_ahead_ckpt"] and step >= 1:
                if self.managers[pod].latest_step() != step - 1:
                    self.managers[pod].save(step - 1, self.state,
                                            move_ahead=True)
                self._sim_ckpt_age[pod] = 0.0

        # localized rollback: ONLY the failed pod's state rolls back; in
        # synchronous DP its replica re-executes [ckpt_step, step) with the
        # deterministic pipeline, then rejoins (survivors wait per the
        # decisions above).
        self.state = restored
        for s in range(ckpt_step + 1, step):
            self._advance(s)

        # coordinated re-synchronization checkpoint (the renewal engine's
        # re-anchor: every clock back to zero, epoch gap restarts)
        if self.resync_on_recovery:
            if step >= 1:
                for pod, m in enumerate(self.managers):
                    if m.latest_step() != step - 1:
                        m.save(step - 1, self.state)
            self._sim_ckpt_age[:] = 0.0
            self._bal_since_anchor = 0.0
            self.energy.note_resync(self.ckpt_duration_s)

        applied = None
        if self.controller is not None:
            self.controller.observe_failure(gap_s=gap_s, failed_pod=failed_pod)
            remaining_work_s = None if end_step is None else \
                (end_step - step) * self.cluster.step_time_s
            policy = self.controller.maybe_retune(
                trainer=self, remaining_work_s=remaining_work_s, step=step)
            if policy is not None:
                applied = self._apply_policy(policy)

        self.events.append({
            "kind": "failure",
            "step": step,
            "pod": failed_pod,
            "rollback_to": ckpt_step,
            "reexec_steps": reexec,
            "gap_s": gap_s,
            "saving_j": event.saving_j,
            "saving_pct": event.saving_pct,
            "decisions": event.decisions,
            "policy": applied,
        })
