"""Algorithm 1 of the paper: per-survivor strategy selection, on tensors.

Counterpart of ``repro.core.strategies``: the vectorized form
(``evaluate_strategies_impl``, a trailing ladder axis ``F``) and the
F-unrolled running-argmin fold (``evaluate_strategies_fold``) that the
renewal kernel inlines.  Decision semantics are the reference's: a level is
infeasible if the intervened node would make the recovered process wait;
the wait action follows the sleep gate (eq. 8); the selected level minimizes
EI(f); the reference ENI is "continue at ``ref_level``".  Both forms keep
the first minimum (``argmin`` / a strict ``<``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import energy_model as em

__all__ = ["Decision", "evaluate_strategies_impl", "evaluate_strategies_fold"]


@dataclasses.dataclass(frozen=True)
class Decision:
    """Selected strategy per node. All tensors share the node batch shape."""

    level: torch.Tensor          # selected ladder index for the compute phase
    freq_ghz: torch.Tensor       # its frequency
    comp_changed: torch.Tensor   # bool: compute level differs from ref_level
    wait_action: torch.Tensor    # em.WaitAction value (int32)
    comp_time: torch.Tensor      # compute-phase duration under the decision (s)
    wait_time: torch.Tensor      # waiting-phase duration under the decision (s)
    energy_intervened: torch.Tensor   # EI at the decision (J)
    energy_reference: torch.Tensor    # ENI (J)
    saving: torch.Tensor         # eq (1): ENI - EI (J)
    saving_pct: torch.Tensor     # 100 * saving / ENI
    feasible_any: torch.Tensor   # at least one ladder level was feasible


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _level_value(per_level, level):
    """``per_level[level]`` for a ladder-first ``per_level`` ((F,) or
    (F, *batch)) and an integer ``level`` tensor."""
    out = torch.zeros(torch.broadcast_shapes(level.shape, per_level.shape[1:]),
                      dtype=per_level.dtype, device=level.device)
    for f in range(per_level.shape[0]):
        out = torch.where(level == f, per_level[f], out)
    return out


def evaluate_strategies_impl(t_comp_fa, t_failed, n_ckpt, t_ckpt,
                             ladder: em.LadderArrays, sleep: em.SleepArrays,
                             wait_mode, p_idle_wait, mu1=6.0, mu2=1.0,
                             per_level_n_ckpt=False, ref_level=0) -> Decision:
    """Run Algorithm 1 for a batch of surviving nodes (vectorized over a
    trailing ladder axis; ``ladder`` fields are ``(F,)``).

    Node inputs broadcast and are cast to float32 (``wait_mode`` to int32),
    as in the reference.  With ``per_level_n_ckpt`` the checkpoint count
    carries a trailing ladder axis.  ``ref_level`` is the nodes' current
    ladder level, one python int (per-node levels, the reference's
    single-failure extension, are not needed by the renewal engines).
    """
    dev = torch.as_tensor(t_failed).device
    t_comp_fa, t_failed, wait_mode = torch.broadcast_tensors(
        _f32(t_comp_fa, dev), _f32(t_failed, dev),
        torch.as_tensor(wait_mode, dtype=torch.int32, device=dev))
    n_ckpt = _f32(n_ckpt, dev)
    if not per_level_n_ckpt:
        n_ckpt = n_ckpt.expand(t_comp_fa.shape)
    ei = em.intervention_energy(
        t_comp_fa, t_failed, n_ckpt, t_ckpt, ladder, sleep, wait_mode,
        p_idle_wait, mu1=mu1, mu2=mu2, per_level_n_ckpt=per_level_n_ckpt)
    level = torch.argmin(ei["total"], dim=-1)
    take = lambda a: em.take_level(a, level)

    ref_level = int(ref_level)
    ct_ref = em.take_level(ei["comp_t"], ref_level)
    ce_ref = em.take_level(ei["e_comp"], ref_level)
    eni = ce_ref + em.awake_wait_energy(
        t_failed - ct_ref, wait_mode, ladder, p_idle_wait, spin_level=ref_level)
    e_sel = take(ei["total"])
    feasible_any = torch.any(ei["feasible"], dim=-1)
    # nothing feasible (numerical guard): keep the current level, no action
    e_sel = torch.where(feasible_any, e_sel, eni)
    level = torch.where(feasible_any, level, ref_level)

    sleeps = take(ei["sleeps"]) & feasible_any
    active = wait_mode == int(em.WaitMode.ACTIVE)
    wait_action = torch.where(
        sleeps, int(em.WaitAction.SLEEP),
        torch.where(active, int(em.WaitAction.MIN_FREQ),
                    int(em.WaitAction.NONE))).to(torch.int32)
    wait_action = torch.where(feasible_any, wait_action,
                              int(em.WaitAction.NONE)).to(torch.int32)
    saving = eni - e_sel
    return Decision(
        level=level.to(torch.int32),
        freq_ghz=_level_value(ladder.freq_ghz, level),
        comp_changed=level != ref_level,
        wait_action=wait_action,
        comp_time=take(ei["comp_t"]),
        wait_time=take(ei["wait_t"]),
        energy_intervened=e_sel,
        energy_reference=eni,
        saving=saving,
        saving_pct=100.0 * saving / torch.clamp_min(eni, 1e-9),
        feasible_any=feasible_any,
    )


def evaluate_strategies_fold(t_comp_fa, t_failed, n_ckpt_cols, t_ckpt,
                             ladder: em.LadderArrays, sleep: em.SleepArrays,
                             wait_mode, p_idle_wait, mu1=6.0, mu2=1.0,
                             ref_level: int = 0) -> Decision:
    """Algorithm 1 as an F-unrolled running-argmin fold over ladder levels.

    Equivalent to ``evaluate_strategies_impl`` with every energy term in the
    same operation order; the strict ``<`` keeps the first minimum like
    ``argmin``.  Per-level checkpoint counts arrive as ``n_ckpt_cols`` (F
    node-batch tensors); ladder and sleep fields may carry batch axes after
    the ladder axis (per-lane ladders), as may ``mu1``/``mu2``/
    ``p_idle_wait``/``wait_mode``.  Everything is float32, so a float64
    caller cannot promote the energy math.  The CUDA renewal kernel
    (kernels/csrc/renewal_scan.cu) evaluates exactly this fold per thread.
    """
    dev = torch.as_tensor(t_failed).device
    t_comp_fa, t_failed, wait_mode = torch.broadcast_tensors(
        _f32(t_comp_fa, dev), _f32(t_failed, dev),
        torch.as_tensor(wait_mode, dtype=torch.int32, device=dev))
    t_ckpt, mu1, mu2 = _f32(t_ckpt, dev), _f32(mu1, dev), _f32(mu2, dev)
    ref_level = int(ref_level)
    active = wait_mode == int(em.WaitMode.ACTIVE)
    min_level = ladder.num_levels - 1
    p_awake = torch.where(active, ladder.p_comp[min_level], p_idle_wait)
    feas_rhs = t_failed * (1.0 + 1e-6) + 1e-3
    trans_t, trans_e = sleep.transition_time, sleep.transition_energy
    gate_t = mu1 * trans_t

    best = None
    for f in range(ladder.num_levels):
        n_f = _f32(n_ckpt_cols[f], dev)
        # same op order as comp_time / comp_energy / the wait branches
        ct = t_comp_fa * ladder.beta[f] + n_f * t_ckpt * ladder.gamma[f]
        feasible = ct <= feas_rhs
        wt = t_failed - ct
        e_comp = t_comp_fa * ladder.beta[f] * ladder.p_comp[f] \
            + n_f * t_ckpt * ladder.gamma[f] * ladder.p_ckpt[f]
        e_awake = torch.clamp_min(wt, 0.0) * p_awake
        e_sleep = trans_e + torch.clamp_min(wt - trans_t, 0.0) * sleep.p_sleep
        sleeps = (wt > gate_t) & (e_sleep < mu2 * e_awake)
        total = torch.where(
            feasible, e_comp + torch.where(sleeps, e_sleep, e_awake), torch.inf)
        if f == ref_level:
            ct_ref, e_comp_ref, sleeps_ref = ct, e_comp, sleeps
        if best is None:
            best = dict(total=total, level=torch.zeros_like(wait_mode),
                        ct=ct, sleeps=sleeps, feasible_any=feasible)
        else:
            better = total < best["total"]  # strict: first minimum, as argmin
            best = dict(
                total=torch.where(better, total, best["total"]),
                level=torch.where(better, f, best["level"]).to(torch.int32),
                ct=torch.where(better, ct, best["ct"]),
                sleeps=torch.where(better, sleeps, best["sleeps"]),
                feasible_any=best["feasible_any"] | feasible,
            )

    eni = e_comp_ref + torch.clamp_min(t_failed - ct_ref, 0.0) * torch.where(
        active, ladder.p_comp[ref_level], p_idle_wait)
    feasible_any = best["feasible_any"]
    e_sel = torch.where(feasible_any, best["total"], eni)
    level = torch.where(feasible_any, best["level"], ref_level).to(torch.int32)
    comp_time = torch.where(feasible_any, best["ct"], ct_ref)
    sleeps = torch.where(feasible_any, best["sleeps"], sleeps_ref) & feasible_any
    wait_action = torch.where(
        sleeps, int(em.WaitAction.SLEEP),
        torch.where(active, int(em.WaitAction.MIN_FREQ),
                    int(em.WaitAction.NONE))).to(torch.int32)
    wait_action = torch.where(feasible_any, wait_action,
                              int(em.WaitAction.NONE)).to(torch.int32)
    saving = eni - e_sel
    return Decision(
        level=level,
        freq_ghz=_level_value(ladder.freq_ghz, level),
        comp_changed=level != ref_level,
        wait_action=wait_action,
        comp_time=comp_time,
        wait_time=t_failed - comp_time,
        energy_intervened=e_sel,
        energy_reference=eni,
        saving=saving,
        saving_pct=100.0 * saving / torch.clamp_min(eni, 1e-9),
        feasible_any=feasible_any,
    )
