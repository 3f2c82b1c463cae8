"""Checkpoint-sawtooth closed forms on torch tensors.

Counterpart of the analytic phase geometry in ``repro.core.planning``
(``advance_checkpoint_sawtooth``, ``balanced_span``,
``timer_checkpoint_count``, ``checkpoint_plan``).  The reference dispatches
between numpy and jnp; here every function takes torch tensors (python
floats broadcast as scalars) and is generic over their dtype: float64 on
the host oracle, float32 in the kernel's plain version.  Each expression
keeps the reference's operation order, so the float32 results round the
same way as the CUDA kernel that inlines them (built without contraction).

``expected_savings`` and ``optimal_checkpoint_interval`` arrive with the
rest of ``core.optimize`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "CheckpointPlan",
    "advance_checkpoint_sawtooth",
    "balanced_span",
    "timer_checkpoint_count",
    "checkpoint_plan",
]


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
