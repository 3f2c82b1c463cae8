"""Checkpoint-sawtooth closed forms on torch tensors.

Counterpart of the analytic phase geometry in ``repro.core.planning``
(``advance_checkpoint_sawtooth``, ``balanced_span``,
``timer_checkpoint_count``, ``checkpoint_plan``).  The reference dispatches
between numpy and jnp; here every function takes torch tensors (python
floats broadcast as scalars) and is generic over their dtype: float64 on
the host oracle, float32 in the kernel's plain version.  Each expression
keeps the reference's operation order, so the float32 results round the
same way as the CUDA kernel that inlines them (built without contraction).

On top sit the expected-energy planners: ``expected_savings`` (E[saving]
and the action mix when the failure is uniform in the checkpoint interval)
and ``optimal_checkpoint_interval`` (a Young/Daly-style energy optimum, the
transparent sanity oracle of the renewal optimizer), each one Algorithm-1
dispatch on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import strategies
from repro_torch.core.characterization import MachineProfile

__all__ = [
    "ExpectedSavings",
    "CheckpointPlan",
    "advance_checkpoint_sawtooth",
    "balanced_span",
    "timer_checkpoint_count",
    "checkpoint_plan",
    "expected_savings",
    "optimal_checkpoint_interval",
]


def _ns(*arrays):
    """numpy/torch namespace dispatch: torch iff any input is a tensor (the
    reference's numpy/jnp ``_ns``), for helpers that serve host numpy and
    device tensors alike (``topology.survivor_slot_mask``)."""
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


def advance_checkpoint_sawtooth(age0, delta, interval, dur):
    """Advance a timer-checkpoint sawtooth by ``delta`` wall seconds.

    A node executes at fa and a timer checkpoint of duration ``dur`` fires
    whenever the wall age since the last checkpoint end reaches
    ``interval``.  Failure instants landing inside a checkpoint snap forward
    to its end (age 0).  Returns ``(age, work, n_fired, delta_eff)`` —
    see the reference for the full semantics.
    """
    first = interval - age0                 # wall time of the first timer fire
    period = interval + dur
    fired = delta >= first
    q = torch.clamp_min(delta - first, 0.0)
    j = torch.floor(q / period)             # index of the last fire <= delta
    r = q - j * period                      # time since that fire began
    mid = fired & (r < dur)                 # failure lands inside a checkpoint
    n_fired = torch.where(fired, j + 1.0, 0.0)
    age = torch.where(fired, torch.where(mid, 0.0, r - dur), age0 + delta)
    delta_eff = torch.where(mid, first + j * period + dur, delta)
    work = delta_eff - n_fired * dur
    return age, work, n_fired, delta_eff


def balanced_span(age0, span, interval, dur):
    """Split a balanced-execution span into ``(work, ckpt_time)`` wall time.

    No mid-checkpoint snapping: a span ending inside a checkpoint counts the
    partial checkpoint, so the pair always sums to ``span``.
    """
    first = interval - age0
    period = interval + dur
    q = torch.clamp_min(span - first, 0.0)
    j = torch.floor(q / period)
    r = q - j * period
    ckpt = torch.where(span > first, j * dur + torch.clamp_max(r, dur), 0.0)
    return span - ckpt, ckpt


@dataclasses.dataclass(frozen=True)
class CheckpointPlan:
    """Decision-time checkpoint forecast for the intervention interval.

    ``n_timer``/``n_ckpt`` carry a trailing ladder axis (..., F); the rest
    share the node batch shape.  ``n_ckpt = n_timer + planned move-ahead``.
    """

    n_timer: Any
    n_ckpt: Any
    plan_move: Any
    age_at_block_fa: Any
    wait_at_block_fa: Any


def timer_checkpoint_count(exec_rem, age, beta, interval, eps: float = 1e-9):
    """``max(0, ceil((exec_rem*beta + age - interval)/interval - eps))``:
    timer checkpoints firing during a (stretched) compute phase."""
    return torch.clamp_min(
        torch.ceil((exec_rem * beta + age - interval) / interval - eps), 0.0)


def checkpoint_plan(exec_rem, age, t_failed, *, interval, dur, beta, gamma,
                    move_ahead, move_frac, eps: float = 1e-9):
    """Closed-form checkpoint plan per (node, ladder level).

    ``beta``/``gamma`` carry the ladder on their TRAILING axis and broadcast
    against ``exec_rem[..., None]`` (``(F,)`` for one profile).  The
    move-ahead is decided once on the un-stretched fa timeline (paper §4.1).
    ``gamma`` is accepted for signature parity; the count does not use it
    (the checkpoint-duration terms cancel).
    """
    del gamma
    # a batched interval broadcasts against the node batch; give it the
    # trailing ladder axis the per-level count carries
    interval_l = (interval[..., None] if isinstance(interval, torch.Tensor)
                  and interval.dim() > 0 else interval)
    n_timer = timer_checkpoint_count(
        exec_rem[..., None], age[..., None], beta, interval_l, eps)
    n0 = n_timer[..., 0]
    wait_at_block_fa = t_failed - (exec_rem + n0 * dur)
    last_timer_end = torch.where(
        n0 > 0,
        (interval - age) + (n0 - 1.0) * (interval + dur) + dur,
        -age,
    )
    age_at_block_fa = exec_rem + n0 * dur - last_timer_end
    plan_move = (
        torch.as_tensor(move_ahead, dtype=torch.bool, device=exec_rem.device)
        & (age_at_block_fa > move_frac * interval)
        & (wait_at_block_fa > dur)
    )
    n_ckpt = n_timer + torch.where(plan_move, 1.0, 0.0).to(n_timer.dtype)[..., None]
    return CheckpointPlan(n_timer=n_timer, n_ckpt=n_ckpt, plan_move=plan_move,
                          age_at_block_fa=age_at_block_fa,
                          wait_at_block_fa=wait_at_block_fa)


# ---------------------------------------------------------------------------
# expected-energy planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExpectedSavings:
    mean_saving_j: float
    mean_saving_pct: float
    p_sleep: float
    p_min_freq: float
    p_comp_change: float
    grid: int


def _linspace0(stop: float, num: int, device) -> torch.Tensor:
    """``num`` float32 points from 0 to ``stop``: the grid
    ``jnp.linspace(0.0, stop, num)`` gives on the reference's backend
    (``i * (stop * (1 / (num - 1)))`` in float32, ``stop`` last), which
    ``torch.linspace`` does not reproduce bit for bit."""
    if num < 2:
        return torch.zeros((num,), dtype=torch.float32, device=device)
    f4 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    step = f4(stop) * (f4(1.0) / f4(num - 1))
    ramp = torch.arange(num - 1, dtype=torch.float32, device=device) * step
    return torch.cat([ramp, f4(stop)[None]])


def _expected(decision, rows: int) -> list:
    """One ``ExpectedSavings`` per leading row of a (rows, grid) decision."""
    saving = decision.saving.double().cpu().numpy().reshape(rows, -1)
    saving_pct = decision.saving_pct.double().cpu().numpy().reshape(rows, -1)
    actions = decision.wait_action.cpu().numpy().reshape(rows, -1)
    comp_changed = decision.comp_changed.cpu().numpy().reshape(rows, -1)
    return [
        ExpectedSavings(
            mean_saving_j=float(saving[i].mean()),
            mean_saving_pct=float(saving_pct[i].mean()),
            p_sleep=float(np.mean(actions[i] == em.WaitAction.SLEEP)),
            p_min_freq=float(np.mean(actions[i] == em.WaitAction.MIN_FREQ)),
            p_comp_change=float(np.mean(comp_changed[i])),
            grid=int(saving.shape[1]),
        )
        for i in range(rows)
    ]


def expected_savings(profile: MachineProfile, *, ckpt_interval_s: float,
                     t_down_s: float, t_restart_s: float,
                     comp_to_block_s: float, t_ckpt_s: float = 120.0,
                     wait_mode: int = 0, grid: int = 512,
                     device="cuda") -> ExpectedSavings:
    """E[saving] for one survivor when the failure instant is uniform over
    the failed node's checkpoint interval (re-execution ~ U[0, interval]),
    on a ``grid``-point float32 grid, one Algorithm-1 dispatch on
    ``device``; means are taken on the host in float64."""
    dev = resolve_device(device)
    reexec = _linspace0(ckpt_interval_s, grid, dev)
    t_failed = t_down_s + t_restart_s + reexec + comp_to_block_s
    d = strategies.evaluate_strategies_profile(
        profile, torch.full((grid,), comp_to_block_s, device=dev), t_failed,
        torch.zeros((grid,), device=dev), t_ckpt_s,
        torch.full((grid,), wait_mode, dtype=torch.int32, device=dev),
        device=dev)
    return _expected(d, 1)[0]


def _expected_savings_grid(profile: MachineProfile, intervals: np.ndarray, *,
                           t_down_s: float, t_restart_s: float,
                           comp_to_block_s: float, t_ckpt_s: float,
                           wait_mode: int, grid: int, device) -> list:
    """``expected_savings`` for a whole interval batch in one dispatch over
    the (interval, failure-phase) grid (I, G); one ``ExpectedSavings`` per
    interval."""
    ivals = torch.as_tensor(np.asarray(intervals, np.float64), device=device
                            ).to(torch.float32)[:, None]           # (I, 1)
    reexec = ivals * _linspace0(1.0, grid, device)[None, :]        # (I, G)
    t_failed = t_down_s + t_restart_s + reexec + comp_to_block_s
    d = strategies.evaluate_strategies_profile(
        profile, torch.full(reexec.shape, comp_to_block_s, device=device),
        t_failed, torch.zeros(reexec.shape, device=device), t_ckpt_s,
        torch.full(reexec.shape, wait_mode, dtype=torch.int32, device=device),
        device=device)
    return _expected(d, len(intervals))


def optimal_checkpoint_interval(profile: MachineProfile, *, mtbf_s: float,
                                t_ckpt_s: float = 120.0,
                                t_down_s: float = 60.0,
                                t_restart_s: float = 60.0,
                                comp_to_block_s: float = 300.0,
                                n_survivors: int = 3, wait_mode: int = 0,
                                intervals: Optional[np.ndarray] = None,
                                device="cuda"):
    """Sweep the checkpoint interval for minimum expected energy overhead
    per unit of useful work (a single-failure, fixed-workload first-order
    model; the renewal optimizer is the deployment answer).

    Per interval T (cluster failure rate 1/mtbf, failure uniform within T),
    both terms price the whole (n_survivors + 1)-node cluster: checkpoint
    power ``(n+1) (T_ckpt/T) P_ckpt`` and failure overhead ``E[failure
    energy]/mtbf`` — re-execution E[T/2] at P_comp plus the survivors'
    wait energy, minus the strategy savings (``expected_savings``).  The
    (interval x failure-phase) grid is one dispatch on ``device``.  Returns
    ``(best_interval_s, rows)``, a dict per interval including the
    no-strategy overhead (near Young's sqrt(2 T_ckpt mtbf)).
    """
    dev = resolve_device(device)
    pt = profile.power_table
    p_comp = float(pt.p_comp[0])
    p_ckpt = float(pt.p_ckpt[0])
    if intervals is None:
        young = np.sqrt(2.0 * t_ckpt_s * mtbf_s)
        intervals = young * np.geomspace(0.25, 4.0, 17)
    intervals = np.asarray(intervals, np.float64)

    expectations = _expected_savings_grid(
        profile, intervals, t_down_s=t_down_s, t_restart_s=t_restart_s,
        comp_to_block_s=comp_to_block_s, t_ckpt_s=t_ckpt_s,
        wait_mode=wait_mode, grid=512, device=dev)
    rows = []
    for T, exp in zip(intervals, expectations):
        # every node checkpoints, so the overhead is per-cluster, as the
        # failure terms are
        ckpt_rate = (n_survivors + 1) * (t_ckpt_s / T) * p_ckpt
        reexec_e = (T / 2.0) * p_comp
        mean_wait = t_down_s + t_restart_s + T / 2.0
        survivors_ref = n_survivors * mean_wait * p_comp
        survivors_saved = n_survivors * exp.mean_saving_j
        fail_rate_no_strategy = (reexec_e + survivors_ref) / mtbf_s
        fail_rate_strategy = (reexec_e + survivors_ref - survivors_saved) / mtbf_s
        rows.append({
            "interval_s": float(T),
            "overhead_w_no_strategy": ckpt_rate + fail_rate_no_strategy,
            "overhead_w_with_strategy": ckpt_rate + fail_rate_strategy,
            "mean_saving_pct": exp.mean_saving_pct,
            "p_sleep": exp.p_sleep,
        })
    best = min(rows, key=lambda r: r["overhead_w_with_strategy"])
    return best["interval_s"], rows
