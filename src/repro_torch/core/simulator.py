"""Event-driven fault-tolerance / energy simulator (paper §4.1).

Counterpart of ``repro.core.simulator``: the scenario configs
(``NodeStart``, ``ScenarioConfig``), the single-failure event oracle
``simulate``, the multi-failure renewal oracle ``simulate_run`` and the
Table-4 view ``compare``.  One representative process per node; the
survivors execute until each blocks on a rendezvous with the recovering
process, and at the failure instant the runtime evaluates Algorithm 1 for
every survivor (``strategies.evaluate_strategies_profile``, one dispatch
on ``device``) and applies the selected compute level and wait action.

The engine is host code by nature: a heap-based discrete-event scheduler in
float64 Python with exact piecewise-constant power integration; only the
Algorithm-1 dispatch runs on ``device``.  The execution model (progress in
fa-seconds, timer checkpoints, move-ahead, the failed node's down ->
restart -> re-execute timeline, the intervention window) is the
reference's; see its module docstring.  ``simulate_run`` draws its
history from any failure process, or from the correlated shock sampler of
``core.topology`` (``topology=``).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import failures
from repro_torch.core import planning
from repro_torch.core import strategies
from repro_torch.core import topology as node_topology
from repro_torch.core.characterization import MachineProfile, paper_machine_profile

__all__ = [
    "NodeStart",
    "ScenarioConfig",
    "Segment",
    "NodeOutcome",
    "SimResult",
    "ComparisonRow",
    "EpochRecord",
    "RunResult",
    "simulate",
    "simulate_run",
    "compare",
]


class Phase(enum.Enum):
    EXEC = "exec"
    CKPT = "ckpt"
    WAIT_ACTIVE = "wait_active"
    WAIT_IDLE = "wait_idle"
    GO_SLEEP = "go_sleep"
    SLEEP = "sleep"
    WAKEUP = "wakeup"
    DOWN = "down"
    RESTART = "restart"
    REEXEC = "reexec"


@dataclasses.dataclass(frozen=True)
class NodeStart:
    """Pre-failure state of a surviving node at the failure instant (t=0).

    ``peer``: 0 = rendezvous with the failed process; i > 0 = with survivor
    i (a blocking chain; peers precede their children and the shared
    progress point lies after the peer's own block).  ``level`` is the
    node's current DVFS ladder level (0 = fa); the reference run and
    Algorithm 1's ENI baseline both continue at it.
    """

    exec_to_rendezvous: float      # fa-seconds of work until the next rendezvous
    rendezvous_period: float = 3600.0
    ckpt_age: float = 60.0         # wall seconds since last checkpoint end
    peer: int = 0                  # 0 = the failed process; i>0 = survivor i
    level: int = 0                 # current DVFS ladder level (0 = fa)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    name: str
    survivors: tuple
    t_down: float
    t_restart: float
    t_reexec: float
    profile: MachineProfile = dataclasses.field(default_factory=paper_machine_profile)
    ckpt_interval: float = 3600.0
    ckpt_duration: float = 120.0
    wait_mode: em.WaitMode = em.WaitMode.ACTIVE
    move_ahead: bool = True
    move_ahead_frac: float = 0.5
    mu1: float = 6.0
    mu2: float = 1.0

    @property
    def t_recover(self) -> float:
        return self.t_down + self.t_restart + self.t_reexec


@dataclasses.dataclass
class Segment:
    node: int
    t0: float
    t1: float
    phase: Phase
    power: float
    level: int = 0

    @property
    def energy(self) -> float:
        return (self.t1 - self.t0) * self.power

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class NodeOutcome:
    node: int
    level: int                 # compute-phase ladder level applied
    freq_ghz: float
    wait_action: em.WaitAction
    comp_phase: float          # duration incl. move-ahead checkpoint (s)
    wait_phase: float          # duration (s)
    window: float              # intervention interval duration TT (s)
    energy: float              # joules over the window
    predicted_saving: float    # Algorithm-1 prediction at decision time (J)


@dataclasses.dataclass
class SimResult:
    config: ScenarioConfig
    intervene: bool
    segments: list
    outcomes: dict             # node -> NodeOutcome

    def node_segments(self, node: int):
        return [s for s in self.segments if s.node == node]


@dataclasses.dataclass
class ComparisonRow:
    """One Table-4 row."""

    node: int
    comp_action: str
    comp_phase_min: float
    wait_action: str
    wait_phase_min: float
    total_min: float
    save_j: float
    save_j_per_s: float
    save_pct: float


# ---------------------------------------------------------------------------
# event engine
# ---------------------------------------------------------------------------

_FAILED = 0  # the failed node id; survivors are 1..N


class _Proc:
    def __init__(self, node: int):
        self.node = node
        self.progress = 0.0          # fa-seconds of completed work
        self.level = 0               # ladder level while executing
        self.t_last = 0.0            # time of last progress update
        self.phase: Optional[Phase] = None
        self.last_ckpt_end = 0.0
        self.rendezvous_target = math.inf
        self.wait_action = em.WaitAction.NONE
        self.window_end: Optional[float] = None
        self.seq = 0                 # event-generation counter (stale-event guard)


def _power(profile: MachineProfile, phase: Phase, level: int, wait_level: int,
           wait_mode: em.WaitMode) -> float:
    pt = profile.power_table
    if phase == Phase.EXEC:
        return float(pt.p_comp[level])
    if phase == Phase.CKPT:
        return float(pt.p_ckpt[level])
    if phase == Phase.WAIT_ACTIVE:
        return float(pt.p_comp[wait_level])
    if phase == Phase.WAIT_IDLE:
        return float(profile.p_idle_wait)
    if phase == Phase.GO_SLEEP:
        return float(profile.sleep.p_go_sleep)
    if phase == Phase.SLEEP:
        return float(profile.sleep.p_sleep)
    if phase == Phase.WAKEUP:
        return float(profile.sleep.p_wakeup)
    if phase == Phase.DOWN:
        return 0.0
    if phase == Phase.RESTART:
        return float(pt.p_ckpt[0])
    if phase == Phase.REEXEC:
        return float(pt.p_comp[0])
    raise ValueError(phase)


def simulate(cfg: ScenarioConfig, intervene: bool, *, device="cuda") -> SimResult:
    """Run one scenario (reference or intervened); Algorithm 1 on
    ``device``."""
    dev = resolve_device(device)
    profile = cfg.profile
    pt = profile.power_table
    n_survivors = len(cfg.survivors)
    min_level = pt.min_index

    # --- plan + Algorithm 1 decisions at failure time (t=0) ----------------
    exec_rem = np.array([s.exec_to_rendezvous for s in cfg.survivors])
    # rendezvous-completion times in chain (topological) order: direct
    # blockers wait for the recovering process; chained blockers wait for
    # their (blocked) peer to resume and reach the shared progress point.
    t_failed = np.zeros(len(cfg.survivors))
    for i, sv in enumerate(cfg.survivors):
        if sv.peer == 0:
            t_failed[i] = cfg.t_recover + exec_rem[i]         # eq (14)/(15)
        else:
            j = sv.peer - 1
            if j >= i:
                raise ValueError("peers must precede their children in survivors")
            if exec_rem[i] <= exec_rem[j]:
                raise ValueError(
                    "chained rendezvous must lie after the peer's block point")
            t_failed[i] = t_failed[j] + (exec_rem[i] - exec_rem[j])
    ages = np.array([s.ckpt_age for s in cfg.survivors])
    # per (node, level) checkpoint plan: timer checkpoints firing during the
    # (stretched) compute phase plus a move-ahead decided on the fa timeline
    # (planning.checkpoint_plan, shared with the sweep engine), float64
    f8 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    plan = planning.checkpoint_plan(
        f8(exec_rem), f8(ages), f8(t_failed),
        interval=cfg.ckpt_interval, dur=cfg.ckpt_duration,
        beta=f8(pt.beta), gamma=f8(pt.gamma),
        move_ahead=cfg.move_ahead, move_frac=cfg.move_ahead_frac,
    )
    plan_move = plan.plan_move.numpy()
    n_ckpt = plan.n_ckpt.numpy()

    start_levels = np.array([s.level for s in cfg.survivors], dtype=np.int64)
    if np.any(start_levels < 0) or np.any(start_levels >= len(pt.freq_ghz)):
        raise ValueError(f"{cfg.name}: survivor start levels {start_levels} "
                         f"outside ladder [0, {len(pt.freq_ghz)})")
    if intervene:
        decision = strategies.evaluate_strategies_profile(
            profile, exec_rem, t_failed, n_ckpt, cfg.ckpt_duration,
            np.full(n_survivors, int(cfg.wait_mode)),
            mu1=cfg.mu1, mu2=cfg.mu2, per_level_n_ckpt=True,
            ref_level=start_levels, device=dev,
        )
        levels = decision.level.cpu().numpy()
        wait_actions = [em.WaitAction(int(a))
                        for a in decision.wait_action.cpu().numpy()]
        predicted_saving = decision.saving.cpu().numpy()
    else:
        # case B: continue as currently configured
        levels = start_levels
        wait_actions = [em.WaitAction.NONE] * n_survivors
        predicted_saving = np.zeros(n_survivors)
    node_plan_move = {i + 1: bool(plan_move[i]) for i in range(n_survivors)}

    # --- simulation state ---------------------------------------------------
    procs = {i: _Proc(i) for i in range(n_survivors + 1)}
    segments: list = []
    outcomes: dict = {}
    heap: list = []
    counter = 0

    def push(t: float, kind: str, node: int, seq: int):
        nonlocal counter
        heapq.heappush(heap, (t, counter, kind, node, seq))
        counter += 1

    def emit(node: int, t0: float, t1: float, phase: Phase, level: int,
             wait_level: int = 0):
        if t1 > t0:
            segments.append(
                Segment(node, t0, t1, phase,
                        _power(profile, phase, level, wait_level, cfg.wait_mode),
                        level))

    # failed node timeline is fully known up front
    t_restart_end = cfg.t_down + cfg.t_restart
    t_rec = cfg.t_recover
    emit(_FAILED, 0.0, cfg.t_down, Phase.DOWN, 0)
    emit(_FAILED, cfg.t_down, t_restart_end, Phase.RESTART, 0)
    emit(_FAILED, t_restart_end, t_rec, Phase.REEXEC, 0)
    # after recovery the failed proc executes at fa; direct blockers complete
    # at t_rec + exec_rem[i]; chained blockers when their peer reaches the
    # shared point (t_failed, computed in chain order above).
    arrival = {i + 1: float(t_failed[i]) for i in range(n_survivors)}
    fa_end = t_rec + float(np.max(exec_rem)) if n_survivors else t_rec
    emit(_FAILED, t_rec, fa_end, Phase.EXEC, 0)

    # survivors
    for i in range(n_survivors):
        node = i + 1
        p = procs[node]
        p.level = int(levels[i])
        p.wait_action = wait_actions[i]
        p.rendezvous_target = float(exec_rem[i])
        p.last_ckpt_end = -float(cfg.survivors[i].ckpt_age)
        p.phase = Phase.EXEC
        p.t_last = 0.0
        _schedule_next(p, cfg, push)

    wait_start: dict = {}
    comp_end: dict = {}

    def _begin_wait(node: int, t: float):
        p = procs[node]
        comp_end[node] = t
        wait_start[node] = t
        t_arr = arrival[node]
        action = p.wait_action
        if action == em.WaitAction.SLEEP:
            sl = profile.sleep
            t_go_end = t + sl.t_go_sleep
            t_wake_start = max(t_arr - sl.t_wakeup, t_go_end)
            emit(node, t, t_go_end, Phase.GO_SLEEP, p.level)
            emit(node, t_go_end, t_wake_start, Phase.SLEEP, p.level)
            emit(node, t_wake_start, t_arr, Phase.WAKEUP, p.level)
        elif action == em.WaitAction.MIN_FREQ:
            emit(node, t, t_arr, Phase.WAIT_ACTIVE, p.level, wait_level=min_level)
        else:
            # reference / idle: active waits keep spinning at the node's
            # current level, idle waits block
            if cfg.wait_mode == em.WaitMode.ACTIVE:
                emit(node, t, t_arr, Phase.WAIT_ACTIVE, p.level, wait_level=p.level)
            else:
                emit(node, t, t_arr, Phase.WAIT_IDLE, p.level)
        push(t_arr, "rendezvous_complete", node, procs[node].seq)

    def _on_block(node: int, t: float):
        """Survivor reached its rendezvous point: execute the planned
        move-ahead checkpoint (if any), then enter the wait."""
        p = procs[node]
        do_move = node_plan_move[node] and (
            arrival[node] - t > cfg.ckpt_duration * float(pt.gamma[p.level]) - 1e-9
        )
        if do_move:
            dur = cfg.ckpt_duration * float(pt.gamma[p.level])
            emit(node, t, t + dur, Phase.CKPT, p.level)
            p.last_ckpt_end = t + dur
            _begin_wait(node, t + dur)
        else:
            _begin_wait(node, t)

    # --- event loop ---------------------------------------------------------
    open_windows = set(range(1, n_survivors + 1))
    while heap and open_windows:
        t, _, kind, node, seq = heapq.heappop(heap)
        p = procs[node]
        if seq != p.seq:
            continue  # superseded event
        if kind == "reach_rendezvous":
            p.progress = p.rendezvous_target
            emit(node, p.t_last, t, Phase.EXEC, p.level)
            p.t_last = t
            p.seq += 1
            _on_block(node, t)
        elif kind == "ckpt_timer":
            # flush exec progress, run the checkpoint, resume
            beta = float(pt.beta[p.level])
            p.progress += (t - p.t_last) / beta
            emit(node, p.t_last, t, Phase.EXEC, p.level)
            dur = cfg.ckpt_duration * float(pt.gamma[p.level])
            emit(node, t, t + dur, Phase.CKPT, p.level)
            p.last_ckpt_end = t + dur
            p.t_last = t + dur
            p.seq += 1
            _schedule_next(p, cfg, push, now=t + dur)
        elif kind == "rendezvous_complete":
            p.window_end = t
            open_windows.discard(node)

    # --- account ------------------------------------------------------------
    for i in range(n_survivors):
        node = i + 1
        end = procs[node].window_end
        if end is None:
            raise RuntimeError(f"node {node} window never closed")
        energy = sum(s.energy for s in segments if s.node == node and s.t1 <= end + 1e-9)
        outcomes[node] = NodeOutcome(
            node=node,
            level=int(levels[i]),
            freq_ghz=float(pt.freq_ghz[int(levels[i])]),
            wait_action=wait_actions[i],
            comp_phase=comp_end[node],
            wait_phase=end - wait_start[node],
            window=end,
            energy=energy,
            predicted_saving=float(predicted_saving[i]),
        )
    return SimResult(config=cfg, intervene=intervene, segments=segments,
                     outcomes=outcomes)


def _schedule_next(p: _Proc, cfg: ScenarioConfig, push: Callable,
                   now: Optional[float] = None):
    """Schedule whichever comes first for an executing survivor: the next
    checkpoint timer or reaching the rendezvous progress point."""
    t_now = p.t_last if now is None else now
    beta = float(cfg.profile.power_table.beta[p.level])
    t_reach = t_now + (p.rendezvous_target - p.progress) * beta
    t_ckpt = p.last_ckpt_end + cfg.ckpt_interval
    if t_ckpt < t_reach:
        push(t_ckpt, "ckpt_timer", p.node, p.seq)
    else:
        push(t_reach, "reach_rendezvous", p.node, p.seq)


# ---------------------------------------------------------------------------
# renewal runs: repeated failures over an application makespan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EpochRecord:
    """One handled failure inside a renewal run.  Per-survivor energies
    integrate each node over the whole epoch ``[failure, T_E]`` (window plus
    the trailing fa span), so their difference is the eq. (1) saving."""

    index: int
    t_fail: float              # absolute wall time of the (snapped) failure
    delta: float               # balanced-execution gap from the previous anchor
    config: ScenarioConfig     # system state at the failure instant
    t_renewal: float           # epoch duration T_E (failure -> last rendezvous)
    energy_ref: np.ndarray     # (N,) per-survivor epoch energy, reference run
    energy_int: np.ndarray     # (N,) per-survivor epoch energy, intervened run
    energy_failed: float       # failed + felled node energy over [0, T_E]
    saving: np.ndarray         # (N,) energy_ref - energy_int
    levels: np.ndarray         # (N,) selected ladder levels
    wait_actions: list         # (N,) em.WaitAction
    felled: Optional[np.ndarray] = None  # (N,) survivor slots also felled


@dataclasses.dataclass
class RunResult:
    """Whole-run energy accounting for a multi-failure renewal run."""

    config: ScenarioConfig
    makespan_s: float
    epochs: list               # EpochRecord per handled failure
    n_failures: int
    end_time: float            # wall end of the run (>= makespan_s)
    balanced_energy: float     # inter-failure spans + resync ckpts + tail (J)
    energy_ref: float          # whole run, no intervention (J)
    energy_int: float          # whole run, Algorithm 1 at every failure (J)
    saving: float              # energy_ref - energy_int (J)


def _epoch_node_energy(segments, node: int, t_e: float, p_comp0: float):
    """All of a node's segment energy plus the trailing fa span to ``T_E``."""
    segs = [s for s in segments if s.node == node]
    energy = sum(s.energy for s in segs)
    end = max(s.t1 for s in segs)
    return energy + max(t_e - end, 0.0) * p_comp0


def _balanced_energy(age0: float, span: float, cfg: ScenarioConfig,
                     p_comp0: float, p_ckpt0: float) -> float:
    """Energy of one node executing balanced at fa for ``span`` seconds."""
    w, ck = planning.balanced_span(
        torch.tensor(float(age0), dtype=torch.float64),
        torch.tensor(float(span), dtype=torch.float64),
        cfg.ckpt_interval, cfg.ckpt_duration)
    return float(w) * p_comp0 + float(ck) * p_ckpt0


def simulate_run(cfg: ScenarioConfig, gaps, makespan_s: float, *,
                 process=None, key=None, max_failures: int = 64,
                 felled=None, topology=None, device="cuda") -> RunResult:
    """Event-driven multi-failure renewal run (reference + intervened).

    ``gaps`` are balanced-execution wall seconds between each renewal anchor
    and the next failure; failure ``k`` (and everything after it) is
    dropped once the balanced time consumed so far plus ``gaps[k]`` exceeds
    ``makespan_s``.  Each epoch is simulated by ``simulate`` on the
    analytically shifted state; between epochs the application runs
    balanced at fa; every epoch closes with a coordinated resync checkpoint
    and the state re-anchors (``scenarios.post_recovery_config``).  With
    ``gaps=None`` one history is drawn from ``process`` under ``key`` with
    the renewal engines' sampler (``failures.sample_renewal_gaps``) on
    ``device``.  ``felled`` ((K, N) bool over survivor slots) marks
    survivors rolled back with the primary: such an epoch re-executes to
    the largest lost work, the spared survivors rendezvous against it, and
    each felled node pays the failed node's closed form.  With a
    ``core.topology.Topology`` (and ``gaps=None``) the history and the
    felled sets come from the correlated shock sampler instead.  Semantics
    are the reference's.
    """
    from repro_torch.core.scenarios import (failure_state_at,
                                            post_recovery_config, shift_failure)

    dev = resolve_device(device)
    if gaps is None:
        if process is None or key is None:
            raise ValueError("gaps=None requires a FailureProcess and a key")
        n_nodes = len(cfg.survivors) + 1
        if topology is not None:
            g, fm, pri = node_topology.correlated_renewal_gaps(
                topology, failures.as_process(process), key, 1, n_nodes,
                max_failures, dev)
            gaps = g[0]
            felled = node_topology.survivor_slot_mask(fm, pri)[0]
        else:
            gaps, _ = failures.renewal_gaps(
                failures.as_process(process), key, 1, n_nodes, max_failures,
                dev)
            gaps = gaps[0]
    elif process is not None:
        raise ValueError("pass explicit gaps OR a process, not both")
    elif topology is not None:
        raise ValueError("a topology needs gaps=None (it draws the history); "
                         "pass explicit felled masks with explicit gaps")

    if any(sv.peer != 0 for sv in cfg.survivors):
        raise ValueError(
            f"{cfg.name}: renewal runs require direct blockers (peer == 0)")
    if any(sv.level != 0 for sv in cfg.survivors):
        raise ValueError(
            f"{cfg.name}: renewal runs start from a balanced app (survivor "
            "levels must be 0; non-fa starts are single-failure inputs)")
    pt = cfg.profile.power_table
    p_comp0, p_ckpt0 = float(pt.p_comp[0]), float(pt.p_ckpt[0])
    dur_fa = cfg.ckpt_duration * float(pt.gamma[0])
    n_nodes = len(cfg.survivors) + 1
    n_survivors = len(cfg.survivors)
    gaps = np.asarray(gaps, np.float64)
    if felled is not None:
        felled = np.broadcast_to(np.asarray(felled, bool),
                                 (gaps.shape[0], n_survivors))

    anchor = cfg
    t_anchor = 0.0       # wall clock (balanced spans + epochs + resync ckpts)
    bal_elapsed = 0.0    # balanced-execution time consumed (vs the makespan)
    balanced = 0.0
    epochs: list = []
    e_ref_total = 0.0
    e_int_total = 0.0

    for k, delta in enumerate(gaps):
        delta = float(delta)
        if bal_elapsed + delta > makespan_s:
            break  # arrivals are monotone: later gaps land past makespan too
        st = failure_state_at(anchor, delta)
        shifted = shift_failure(anchor, delta)

        # balanced span up to each node's (snapped) failure instant
        ages = [sv.ckpt_age for sv in anchor.survivors] + [anchor.t_reexec]
        delta_effs = list(st.delta_eff) + [st.delta_eff_failed]
        for age0, d_eff in zip(ages, delta_effs):
            balanced += _balanced_energy(age0, d_eff, anchor, p_comp0, p_ckpt0)

        m = felled[k] if felled is not None else None
        exec_rem = np.array([sv.exec_to_rendezvous for sv in shifted.survivors])
        if m is None or not m.any():
            ref = simulate(shifted, intervene=False, device=dev)
            act = simulate(shifted, intervene=True, device=dev)
            t_e = shifted.t_recover + float(np.max(exec_rem))
            e_ref = np.array([
                _epoch_node_energy(ref.segments, i + 1, t_e, p_comp0)
                for i in range(len(exec_rem))])
            e_int = np.array([
                _epoch_node_energy(act.segments, i + 1, t_e, p_comp0)
                for i in range(len(exec_rem))])
            e_failed = sum(s.energy for s in ref.segments if s.node == _FAILED)
            levels = np.array([act.outcomes[i + 1].level
                               for i in range(len(exec_rem))])
            waits = [act.outcomes[i + 1].wait_action
                     for i in range(len(exec_rem))]
            p_star = None        # default re-anchor (max over exec_rem)
        else:
            # shock epoch: the felled survivors roll back alongside the
            # primary; every recovery runs concurrently at fa, so the
            # spared survivors rendezvous against the LARGEST lost work
            keep = [i for i in range(n_survivors) if not m[i]]
            ages_f = np.array([sv.ckpt_age for sv in shifted.survivors])
            reexec_max = float(max(
                [shifted.t_reexec] + [float(ages_f[i])
                                      for i in np.nonzero(m)[0]]))
            e_ref = np.zeros(n_survivors)
            e_int = np.zeros(n_survivors)
            levels = np.zeros(n_survivors, dtype=np.int64)
            waits = [em.WaitAction.NONE] * n_survivors
            if keep:
                sub = dataclasses.replace(
                    shifted,
                    survivors=tuple(shifted.survivors[i] for i in keep),
                    t_reexec=reexec_max)
                ref = simulate(sub, intervene=False, device=dev)
                act = simulate(sub, intervene=True, device=dev)
                p_star = float(np.max(exec_rem[keep]))
                t_e = sub.t_recover + p_star
                for j, i in enumerate(keep):
                    e_ref[i] = _epoch_node_energy(
                        ref.segments, j + 1, t_e, p_comp0)
                    e_int[i] = _epoch_node_energy(
                        act.segments, j + 1, t_e, p_comp0)
                    levels[i] = act.outcomes[j + 1].level
                    waits[i] = act.outcomes[j + 1].wait_action
                e_one = sum(s.energy for s in ref.segments
                            if s.node == _FAILED)
            else:
                # every node rolled back: no rendezvous to serve, the
                # epoch is restart + the longest re-execution
                p_star = 0.0
                t_e = shifted.t_down + shifted.t_restart + reexec_max
                e_one = shifted.t_restart * p_ckpt0 + reexec_max * p_comp0
            e_failed = (1.0 + int(m.sum())) * e_one
        # coordinated re-synchronization checkpoint at the renewal point
        balanced += n_nodes * dur_fa * p_ckpt0

        t_fail = t_anchor + float(st.delta_eff_failed)
        epochs.append(EpochRecord(
            index=k,
            t_fail=t_fail,
            delta=delta,
            config=shifted,
            t_renewal=t_e,
            energy_ref=e_ref,
            energy_int=e_int,
            energy_failed=e_failed,
            saving=e_ref - e_int,
            levels=levels,
            wait_actions=waits,
            felled=None if m is None else m.copy(),
        ))
        e_ref_total += float(e_ref.sum()) + e_failed
        e_int_total += float(e_int.sum()) + e_failed
        bal_elapsed += float(st.delta_eff_failed)
        t_anchor = t_fail + t_e + dur_fa
        anchor = post_recovery_config(shifted, p_star=p_star)

    # balanced tail: the rest of the failure-free work (mid-checkpoint snaps
    # can nudge bal_elapsed slightly past the makespan; clamp)
    span = max(makespan_s - bal_elapsed, 0.0)
    if span > 0.0:
        ages = [sv.ckpt_age for sv in anchor.survivors] + [anchor.t_reexec]
        for age0 in ages:
            balanced += _balanced_energy(age0, span, anchor, p_comp0, p_ckpt0)

    return RunResult(
        config=cfg,
        makespan_s=float(makespan_s),
        epochs=epochs,
        n_failures=len(epochs),
        end_time=t_anchor + span,
        balanced_energy=balanced,
        energy_ref=e_ref_total + balanced,
        energy_int=e_int_total + balanced,
        saving=e_ref_total - e_int_total,
    )


# ---------------------------------------------------------------------------
# comparison (Table 4)
# ---------------------------------------------------------------------------

_ACTION_LABEL = {
    em.WaitAction.NONE: "No action",
    em.WaitAction.MIN_FREQ: "min freq",
    em.WaitAction.SLEEP: "sleep",
}


def compare(cfg: ScenarioConfig, *, device="cuda"):
    """Run reference + intervened and produce Table-4-style rows.

    Save(J/s) follows the paper's convention: savings divided by the total
    duration of the phases in which an action was applied (wait phase only
    when the compute frequency is unchanged, the whole interval otherwise).
    Returns ``(rows, reference SimResult, intervened SimResult)``.
    """
    ref = simulate(cfg, intervene=False, device=device)
    act = simulate(cfg, intervene=True, device=device)
    rows = []
    for node in sorted(act.outcomes):
        o = act.outcomes[node]
        r = ref.outcomes[node]
        save = r.energy - o.energy
        comp_changed = o.level != 0
        if comp_changed and o.wait_action != em.WaitAction.NONE:
            denom = o.window
        elif comp_changed:
            denom = o.comp_phase
        elif o.wait_action != em.WaitAction.NONE:
            denom = o.wait_phase
        else:
            denom = o.window
        comp_label = f"{o.freq_ghz:g} GHz" if comp_changed else "No action"
        wait_label = _ACTION_LABEL[o.wait_action]
        if o.wait_action == em.WaitAction.MIN_FREQ:
            wait_label = f"{cfg.profile.power_table.freq_ghz[-1]:g} GHz"
        rows.append(
            ComparisonRow(
                node=node,
                comp_action=comp_label,
                comp_phase_min=o.comp_phase / 60.0,
                wait_action=wait_label,
                wait_phase_min=o.wait_phase / 60.0,
                total_min=o.window / 60.0,
                save_j=save,
                save_j_per_s=save / max(denom, 1e-9),
                save_pct=100.0 * save / max(r.energy, 1e-9),
            )
        )
    return rows, ref, act
