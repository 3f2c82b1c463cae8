"""The paper's six experimental scenarios (§4.3, Table 4) as configs.

Counterpart of ``repro.core.scenarios`` (numpy configs, copied), the
analytic failure-instant shift (``failure_state_at``/``shift_failure``,
float64 through the port's ``planning`` closed forms on CPU tensors, bit
for bit the reference's numpy) and the renewal re-anchor
``post_recovery_anchor`` on torch tensors.  Scenario inputs are
reverse-derived from the published phase durations; see the reference
module for the derivation and the Scenario-3 ladder note.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core import planning
from repro_torch.core.characterization import (
    MachineProfile,
    PowerTable,
    paper_machine_profile,
)
from repro_torch.core.failures import failure_clock_ages
from repro_torch.core.simulator import NodeStart, ScenarioConfig

__all__ = [
    "TABLE4_PUBLISHED",
    "paper_scenarios",
    "scenario",
    "sparse_rendezvous_scenario",
    "apply_policy",
    "FailureState",
    "failure_state_at",
    "failure_clock_ages",
    "shift_failure",
    "post_recovery_anchor",
    "post_recovery_config",
]


# The paper's Table 4 as published: (scenario, node) -> (compute action,
# wait action, saving in J, saving in % of the reference energy).  The
# reproduction bars (tests/test_scenarios.py): actions exact, the saving
# within 0.25% and 0.15 points (scenario 3, whose published row is not
# self-consistent: 2.5% and 1 point).
TABLE4_PUBLISHED = {
    ("scenario1_short_reexec", 1): ("No action", "1.2 GHz", 4400.00, 2.23),
    ("scenario1_short_reexec", 2): ("No action", "sleep", 34034.60, 61.44),
    ("scenario1_short_reexec", 3): ("No action", "sleep", 34034.60, 48.40),
    ("scenario2_long_reexec", 1): ("No action", "sleep", 294294.60, 70.64),
    ("scenario2_long_reexec", 2): ("No action", "sleep", 294294.60, 69.81),
    ("scenario2_long_reexec", 3): ("No action", "sleep", 294294.60, 69.00),
    ("scenario3_freq_behaviour_change", 1): ("2.1 GHz", "sleep", 291346.88, 70.75),
    ("scenario3_freq_behaviour_change", 2): ("2.1 GHz", "sleep", 291448.88, 69.94),
    ("scenario3_freq_behaviour_change", 3): ("2.1 GHz", "sleep", 291550.88, 69.15),
    ("scenario4_short_active_waits", 1): ("1.2 GHz", "1.2 GHz", 12032.00, 24.10),
    ("scenario4_short_active_waits", 2): ("1.7 GHz", "1.2 GHz", 9798.90, 18.12),
    ("scenario4_short_active_waits", 3): ("1.7 GHz", "1.2 GHz", 10311.40, 17.71),
    ("scenario5_short_idle_waits", 1): ("2.1 GHz", "No action", 56.32, 0.17),
    ("scenario5_short_idle_waits", 2): ("2.1 GHz", "No action", 66.32, 0.18),
    ("scenario5_short_idle_waits", 3): ("2.1 GHz", "No action", 76.32, 0.18),
    ("scenario6_no_move_ahead", 1): ("No action", "sleep", 312774.60, 74.74),
    ("scenario6_no_move_ahead", 2): ("No action", "sleep", 312774.60, 73.86),
    ("scenario6_no_move_ahead", 3): ("No action", "sleep", 312774.60, 73.00),
}


def table4_bars(name: str) -> tuple:
    """(relative bar on the saving in J, absolute bar on the saving in %)
    against ``TABLE4_PUBLISHED``."""
    return (0.025, 1.0) if "scenario3" in name else (0.0025, 0.15)


def _scenario3_profile() -> MachineProfile:
    base = paper_machine_profile()
    pt = base.power_table
    table = PowerTable(
        freq_ghz=pt.freq_ghz,
        p_comp=np.array([166.0, 146.0, 137.0, 124.0]),   # -2 W off non-max levels
        beta=np.array([1.0, 1.1, 1.4, 2.0]),             # slowdown moved 0.1 toward 1
        p_ckpt=pt.p_ckpt,
        gamma=pt.gamma,
    )
    return dataclasses.replace(base, power_table=table)


def paper_scenarios() -> dict:
    """name -> ScenarioConfig for the paper's six scenarios."""
    short = dict(t_down=60.0, t_restart=60.0, t_reexec=110.0)       # T_recover 230 s
    long = dict(t_down=60.0, t_restart=60.0, t_reexec=1920.0)       # T_recover 2040 s
    tiny = dict(t_down=60.0, t_restart=39.8, t_reexec=60.0)         # T_recover 159.8 s

    s1 = ScenarioConfig(
        name="scenario1_short_reexec",
        survivors=(
            NodeStart(exec_to_rendezvous=972.0, ckpt_age=600.0),
            NodeStart(exec_to_rendezvous=103.8, ckpt_age=60.0),
            NodeStart(exec_to_rendezvous=193.8, ckpt_age=60.0),
        ),
        ckpt_interval=1800.0,
        **short,
    )
    s2 = ScenarioConfig(
        name="scenario2_long_reexec",
        survivors=(
            NodeStart(exec_to_rendezvous=481.2, ckpt_age=1500.0),
            NodeStart(exec_to_rendezvous=511.2, ckpt_age=1500.0),
            NodeStart(exec_to_rendezvous=541.2, ckpt_age=1500.0),
        ),
        ckpt_interval=3600.0,
        move_ahead_frac=0.5,
        **long,
    )
    s3 = dataclasses.replace(s2, name="scenario3_freq_behaviour_change",
                             profile=_scenario3_profile())
    s4 = ScenarioConfig(
        name="scenario4_short_active_waits",
        survivors=(
            NodeStart(exec_to_rendezvous=141.0, ckpt_age=60.0),
            NodeStart(exec_to_rendezvous=166.0, ckpt_age=60.0),
            NodeStart(exec_to_rendezvous=191.0, ckpt_age=60.0),
        ),
        ckpt_interval=3600.0,
        **tiny,
    )
    s5 = dataclasses.replace(s4, name="scenario5_short_idle_waits",
                             wait_mode=em.WaitMode.IDLE)
    s6 = dataclasses.replace(s2, name="scenario6_no_move_ahead", move_ahead=False)
    return {c.name: c for c in (s1, s2, s3, s4, s5, s6)}


def scenario(index: int) -> ScenarioConfig:
    """Scenario by paper number (1-6)."""
    return list(paper_scenarios().values())[index - 1]


def sparse_rendezvous_scenario(period_s: float = 14400.0,
                               name: str = "long_period") -> ScenarioConfig:
    """Scenario 4's machine on a sparser-rendezvous application — the
    canonical policy-optimization workload (docs/optimize.md §workload
    pinning).

    On the paper's own scenarios (3600 s rendezvous period) the checkpoint-
    interval optimum pins to the workload structure: per-failure resync
    checkpoints cap the loss and the optimum parks just under the period,
    insensitive to MTBF or failure process.  Spreading the rendezvous to
    ``period_s`` (default 4 h, survivors evenly phased at 1/4, 2/4, 3/4 of
    it) restores the classical overhead-vs-re-execution tradeoff the
    optimizer exists to price.  The same definition as the reference's,
    whose tests, examples and policy benchmark use it.
    """
    base = paper_scenarios()["scenario4_short_active_waits"]
    return dataclasses.replace(
        base, name=name,
        survivors=tuple(
            NodeStart(exec_to_rendezvous=period_s * f, rendezvous_period=period_s,
                      ckpt_age=60.0)
            for f in (0.25, 0.5, 0.75)))


def apply_policy(
    cfg: ScenarioConfig,
    *,
    ckpt_interval: float = None,
    mu1: float = None,
    mu2: float = None,
    wait_mode=None,
    move_ahead_frac: float = None,
    move_ahead: bool = None,
) -> ScenarioConfig:
    """A copy of ``cfg`` with operator-tunable knobs replaced.

    The knobs are exactly the policy axes ``core.optimize`` searches over
    (checkpoint timer interval, sleep-gate margins, wait mode, move-ahead
    fraction); ``None`` keeps the scenario's own value.  The paper evaluates
    fixed configurations — this is the hook that turns a ``ScenarioConfig``
    into one *point* of a policy grid, and what the optimizer's
    cross-validation tests use to rebuild a single policy as a standalone
    config.  The returned config goes through the usual validation on use
    (e.g. ``sweep.sweep_inputs`` rejects intervals shorter than the starting
    checkpoint ages).
    """
    updates = {}
    if ckpt_interval is not None:
        updates["ckpt_interval"] = float(ckpt_interval)
    if mu1 is not None:
        updates["mu1"] = float(mu1)
    if mu2 is not None:
        updates["mu2"] = float(mu2)
    if wait_mode is not None:
        updates["wait_mode"] = em.WaitMode(int(wait_mode))
    if move_ahead_frac is not None:
        updates["move_ahead_frac"] = float(move_ahead_frac)
    if move_ahead is not None:
        updates["move_ahead"] = bool(move_ahead)
    return dataclasses.replace(cfg, **updates)


# ---------------------------------------------------------------------------
# analytic failure-instant shifting (substrate of core/sweep.py)
# ---------------------------------------------------------------------------

def _check_ages(age0: np.ndarray, t_reexec: float, interval: float) -> None:
    """No node may start with an overdue timer (age > interval): the
    sawtooth closed form would place that checkpoint in the past."""
    if np.any(age0 > interval) or t_reexec > interval:
        raise ValueError(
            "ckpt_age / t_reexec exceed ckpt_interval: a node cannot be "
            f"older than one timer period (ages {age0.tolist()}, "
            f"t_reexec {t_reexec}, interval {interval})"
        )


@dataclasses.dataclass(frozen=True)
class FailureState:
    """Per-node pre-failure state when the failure lands ``delta`` wall
    seconds after a scenario's reference instant.  Arrays are float64
    numpy, shape (N,) over survivors."""

    delta: float               # requested shift (wall seconds)
    exec_rem: np.ndarray       # fa-seconds of work to each survivor's next rendezvous
    ckpt_age: np.ndarray       # wall seconds since each survivor's last checkpoint end
    delta_eff: np.ndarray      # per-node snapped instant (see advance_checkpoint_sawtooth)
    t_reexec: float            # failed node's lost work = re-execution time at fa
    t_recover: float           # T_down + T_restart + t_reexec  (eq. 15)
    delta_eff_failed: float    # the failed node's own snapped instant


def failure_state_at(cfg: ScenarioConfig, delta: float) -> FailureState:
    """Advance a scenario's pre-failure timeline by ``delta`` wall seconds.

    Every process executes at fa with timer checkpoints every
    ``ckpt_interval`` and rendezvous every ``rendezvous_period`` fa-seconds
    of work, so the state at a later failure instant is analytic: each
    survivor's ``ckpt_age`` follows the checkpoint sawtooth and its
    ``exec_rem`` decreases by the work done, wrapping on the period (in
    ``(0, period]``); the failed node's lost work follows the same
    sawtooth.  Instants inside a checkpoint snap forward to its end
    (``delta_eff``).  Host float64, as the reference.
    """
    if delta < 0:
        raise ValueError("delta must be >= 0")
    f8 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    exec0 = f8([s.exec_to_rendezvous for s in cfg.survivors])
    period = f8([s.rendezvous_period for s in cfg.survivors])
    age0 = f8([s.ckpt_age for s in cfg.survivors])
    _check_ages(age0.numpy(), cfg.t_reexec, cfg.ckpt_interval)
    age, work, _, delta_eff = planning.advance_checkpoint_sawtooth(
        age0, f8(delta), cfg.ckpt_interval, cfg.ckpt_duration)
    rem = torch.remainder(exec0 - work, period)
    exec_rem = torch.where(rem == 0.0, period, rem)
    # failed node: age == lost work at fa between checkpoints
    reexec, _, _, delta_eff_failed = planning.advance_checkpoint_sawtooth(
        f8(cfg.t_reexec), f8(delta), cfg.ckpt_interval, cfg.ckpt_duration)
    t_reexec = float(reexec)
    return FailureState(
        delta=float(delta),
        exec_rem=exec_rem.numpy(),
        ckpt_age=age.numpy(),
        delta_eff=delta_eff.numpy(),
        t_reexec=t_reexec,
        t_recover=cfg.t_down + cfg.t_restart + t_reexec,
        delta_eff_failed=float(delta_eff_failed),
    )


def shift_failure(cfg: ScenarioConfig, delta: float) -> ScenarioConfig:
    """A ``ScenarioConfig`` whose failure lands ``delta`` seconds later —
    the event simulator's input for a shifted instant.  Chained survivors
    (``peer != 0``) are rejected when the shift breaks the chain's
    progress ordering."""
    st = failure_state_at(cfg, delta)
    for i, sv in enumerate(cfg.survivors):
        if sv.peer != 0 and st.exec_rem[i] <= st.exec_rem[sv.peer - 1]:
            raise ValueError(
                f"shift {delta}: chained survivor {i + 1} wrapped past its peer"
            )
    survivors = tuple(
        dataclasses.replace(
            sv,
            exec_to_rendezvous=float(st.exec_rem[i]),
            ckpt_age=float(st.ckpt_age[i]),
        )
        for i, sv in enumerate(cfg.survivors)
    )
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}@+{delta:g}s",
        survivors=survivors,
        t_reexec=st.t_reexec,
    )


def post_recovery_anchor(exec_rem, period, p_star=None):
    """Renewal re-anchor: each survivor's next rendezvous after ``P*``.

    ``exec_rem`` carries survivors on its TRAILING axis; ``period`` is the
    per-survivor rendezvous period.  Returns the first multiple of each
    period strictly past the shared progress point ``P* = max exec_rem``
    (or the given ``p_star``, batch shape of ``exec_rem`` minus the survivor
    axis), in ``(0, period]``.  ``torch.remainder`` is the floor-mod of
    ``jnp.mod`` (the divisor's sign).  Generic over dtype.
    """
    if p_star is None:
        p_star = torch.amax(exec_rem, dim=-1, keepdim=True)
    else:
        p_star = p_star[..., None]
    gap = torch.remainder(p_star - exec_rem, period)
    return torch.where(gap == 0.0, period, period - gap)


def post_recovery_config(cfg: ScenarioConfig, p_star=None) -> ScenarioConfig:
    """Re-anchor a scenario at the renewal point after its failure is
    handled: ages 0, lost work 0, levels fa, and each survivor's next
    rendezvous at the first multiple of its period past ``P*`` (float64).
    Chained blocking topologies are rejected (they do not resynchronize)."""
    if any(sv.peer != 0 for sv in cfg.survivors):
        raise ValueError(
            f"{cfg.name}: renewal re-anchoring requires direct blockers "
            "(peer == 0); chained topologies do not resynchronize at T_E"
        )
    f8 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    exec_rem = f8([s.exec_to_rendezvous for s in cfg.survivors])
    period = f8([s.rendezvous_period for s in cfg.survivors])
    exec_next = post_recovery_anchor(
        exec_rem, period, p_star=None if p_star is None else f8(p_star))
    survivors = tuple(
        dataclasses.replace(sv, exec_to_rendezvous=float(exec_next[i]),
                            ckpt_age=0.0, level=0)
        for i, sv in enumerate(cfg.survivors)
    )
    return dataclasses.replace(cfg, name=f"{cfg.name}|renewed",
                               survivors=survivors, t_reexec=0.0)
