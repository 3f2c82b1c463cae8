"""The paper's six experimental scenarios (§4.3, Table 4) as configs.

Counterpart of ``repro.core.scenarios`` (numpy configs, copied) plus the
renewal re-anchor ``post_recovery_anchor`` on torch tensors.  Scenario
inputs are reverse-derived from the published phase durations; see the
reference module for the derivation and the Scenario-3 ladder note.
``failure_state_at``/``shift_failure`` arrive with the single-failure sweep
(ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.characterization import (
    MachineProfile,
    PowerTable,
    paper_machine_profile,
)
from repro_torch.core.failures import failure_clock_ages
from repro_torch.core.simulator import NodeStart, ScenarioConfig

__all__ = [
    "paper_scenarios",
    "sparse_rendezvous_scenario",
    "apply_policy",
    "failure_clock_ages",
    "post_recovery_anchor",
    "post_recovery_config",
]


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
