"""The renewal Monte-Carlo: whole-run energy across repeated failures.

Counterpart of the renewal subset of ``repro.core.sweep``.  Two engines
share one sampler, so for a fixed key they see the same failure histories:

  * ``engine="kernel"`` (the reference's ``"pallas"``) — the float32
    composition with the Kahan-compensated ledger,
    ``kernels.renewal_scan.renewal_scan``: the hand-written CUDA kernel on a
    card, its plain PyTorch version on the CPU.  Stats only.
  * ``engine="host"`` — ``renewal_compose``, the float64 oracle: a Python
    loop over failure epochs with float64 geometry plus one float32
    Algorithm-1 dispatch over every (run, epoch, survivor) point.

Semantics (occurrence, truncation, re-anchoring, the quiesce policy) are
the reference's; see its module and docs/sweep.md.  The f64 scan engine
(``engine="device"``/``"scan"``), ``renewal_compose_device`` and the
correlated ``topology=`` wait for the next slice (ROADMAP Queue 1) and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import failures
from repro_torch.core import planning
from repro_torch.core import strategies
from repro_torch.core.scenarios import post_recovery_anchor
from repro_torch.core.simulator import ScenarioConfig

__all__ = [
    "SweepInputs",
    "RenewalResult",
    "RenewalDeviceStats",
    "RenewalMonteCarloSummary",
    "sweep_inputs",
    "inputs_from_reference",
    "renewal_failure_gaps",
    "renewal_compose",
    "renewal_monte_carlo_device",
    "renewal_monte_carlo",
    "renewal_monte_carlo_scenarios",
    "renewal_monte_carlo_policies",
]

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0

_NEXT_SLICE = ("arrives with the next slice of the port (ROADMAP.md Queue 1, "
               "item 1: the f64 scan engine, simulate_run and topology=)")


def _not_in_slice(what: str):
    return NotImplementedError(f"{what} {_NEXT_SLICE}")


# ---------------------------------------------------------------------------
# inputs: a ScenarioConfig flattened to tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepInputs:
    """Tensor view of a ``ScenarioConfig`` (leading axes, if any, stack
    scenarios or policies).  ``peer`` is static structure."""

    exec_rem0: torch.Tensor    # (..., N) fa-seconds to each survivor's next rendezvous
    period: torch.Tensor       # (..., N) rendezvous period (fa-seconds of work)
    age0: torch.Tensor         # (..., N) wall seconds since last checkpoint end
    reexec0: torch.Tensor      # (...)  failed node's lost work at the reference instant
    t_down: torch.Tensor
    t_restart: torch.Tensor
    interval: torch.Tensor     # checkpoint timer interval (wall s)
    dur: torch.Tensor          # checkpoint duration at fa (wall s)
    move_ahead: torch.Tensor   # bool
    move_frac: torch.Tensor
    wait_mode: torch.Tensor    # em.WaitMode (int32)
    mu1: torch.Tensor          # sleep-gate margins (eq. 8)
    mu2: torch.Tensor
    p_idle_wait: torch.Tensor
    ladder: em.LadderArrays    # fields (..., F) — ladder axis LAST here
    sleep: em.SleepArrays
    peer: tuple                # static: (N,) blocking topology, 0 = failed process


_LEAVES = ("exec_rem0", "period", "age0", "reexec0", "t_down", "t_restart",
           "interval", "dur", "move_ahead", "move_frac", "wait_mode", "mu1",
           "mu2", "p_idle_wait")
_LADDER = ("freq_ghz", "p_comp", "beta", "p_ckpt", "gamma")
_SLEEP = ("t_go_sleep", "t_wakeup", "p_go_sleep", "p_wakeup", "p_sleep")


def _check_ages(cfg: ScenarioConfig) -> None:
    ages = [s.ckpt_age for s in cfg.survivors]
    if max(ages, default=0.0) > cfg.ckpt_interval or cfg.t_reexec > cfg.ckpt_interval:
        raise ValueError(
            f"{cfg.name}: ckpt_age/t_reexec exceed ckpt_interval "
            f"(ages {ages}, t_reexec {cfg.t_reexec}, interval {cfg.ckpt_interval})")


def sweep_inputs(cfg: ScenarioConfig, dtype=torch.float32,
                 device="cuda") -> SweepInputs:
    """Flatten a ``ScenarioConfig`` into tensors of ``dtype`` on ``device``."""
    dev = resolve_device(device)
    _check_ages(cfg)
    fx = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=dev)
    pt, sl = cfg.profile.power_table, cfg.profile.sleep
    return SweepInputs(
        exec_rem0=fx([s.exec_to_rendezvous for s in cfg.survivors]),
        period=fx([s.rendezvous_period for s in cfg.survivors]),
        age0=fx([s.ckpt_age for s in cfg.survivors]),
        reexec0=fx(cfg.t_reexec),
        t_down=fx(cfg.t_down),
        t_restart=fx(cfg.t_restart),
        interval=fx(cfg.ckpt_interval),
        dur=fx(cfg.ckpt_duration),
        move_ahead=torch.as_tensor(bool(cfg.move_ahead), device=dev),
        move_frac=fx(cfg.move_ahead_frac),
        wait_mode=torch.as_tensor(int(cfg.wait_mode), dtype=torch.int32,
                                  device=dev),
        mu1=fx(cfg.mu1),
        mu2=fx(cfg.mu2),
        p_idle_wait=fx(cfg.profile.p_idle_wait),
        ladder=em.LadderArrays(**{f: fx(getattr(pt, f)) for f in _LADDER}),
        sleep=em.SleepArrays(**{f: fx(getattr(sl, f)) for f in _SLEEP}),
        peer=tuple(s.peer for s in cfg.survivors),
    )


def _stack(inputs: Sequence[SweepInputs]) -> SweepInputs:
    st = lambda xs: torch.stack(list(xs))
    return SweepInputs(
        **{f: st(getattr(i, f) for i in inputs) for f in _LEAVES},
        ladder=em.LadderArrays(**{f: st(getattr(i.ladder, f) for i in inputs)
                                  for f in _LADDER}),
        sleep=em.SleepArrays(**{f: st(getattr(i.sleep, f) for i in inputs)
                                for f in _SLEEP}),
        peer=inputs[0].peer)


def inputs_from_reference(stacked_np: dict, device="cuda") -> SweepInputs:
    """``SweepInputs`` from the reference's (stacked) inputs as numpy.

    ``stacked_np`` maps every ``SweepInputs`` field to a numpy array, with
    ``ladder`` and ``sleep`` as dicts of arrays and ``peer`` a tuple — e.g.
    ``{f: np.asarray(getattr(ref_inputs, f)) ...}``.  The dtypes are kept,
    so the port sees the reference's bits."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    return SweepInputs(
        **{f: t(stacked_np[f]) for f in _LEAVES},
        ladder=em.LadderArrays(**{f: t(stacked_np["ladder"][f]) for f in _LADDER}),
        sleep=em.SleepArrays(**{f: t(stacked_np["sleep"][f]) for f in _SLEEP}),
        peer=tuple(stacked_np.get("peer", ())))


def _check_renewal_config(cfg: ScenarioConfig) -> None:
    """The renewal preconditions shared by every engine."""
    if any(sv.peer != 0 for sv in cfg.survivors):
        raise ValueError(
            f"{cfg.name}: renewal composition requires direct blockers (peer == 0)")
    _check_ages(cfg)
    if any(s.level != 0 for s in cfg.survivors):
        raise ValueError(
            f"{cfg.name}: renewal composition starts from a balanced app "
            "(survivor levels must be 0; non-fa starts are single-failure inputs)")


def _renewal_device_inputs(cfgs, dtype=torch.float32, device="cuda"):
    """Validate and stack scenarios into ``SweepInputs`` with a leading
    scenario axis; returns ``(cfg_list, stacked)``."""
    cfg_list = [cfgs] if isinstance(cfgs, ScenarioConfig) else list(cfgs)
    if not cfg_list:
        raise ValueError("no scenarios to compose")
    for cfg in cfg_list:
        _check_renewal_config(cfg)
    inputs = [sweep_inputs(c, dtype, device) for c in cfg_list]
    shapes = {tuple(i.exec_rem0.shape) for i in inputs}
    ladders = {tuple(i.ladder.freq_ghz.shape) for i in inputs}
    if len(shapes) != 1 or len(ladders) != 1:
        raise ValueError(
            f"stacked scenarios must share survivor count and ladder size "
            f"(got {shapes}, {ladders})")
    return cfg_list, _stack(inputs)


# ---------------------------------------------------------------------------
# failure histories
# ---------------------------------------------------------------------------

def renewal_failure_gaps(key, n_runs: int, n_nodes: int, max_failures: int,
                         mtbf_s: Optional[float] = None,
                         process: Optional[failures.FailureProcess] = None,
                         topology=None, device="cuda"):
    """Per-node failure sequences reduced to renewal-epoch gaps:
    ``(gaps float64, failed_node int64)`` of shape ``(n_runs,
    max_failures)`` on ``device`` — the float64 cast of the float32
    sampler's gaps, so every engine sees the same histories for a key."""
    if topology is not None:
        raise _not_in_slice("the correlated topology= sampler")
    if process is None and mtbf_s is None:
        raise ValueError("provide mtbf_s or a FailureProcess")
    gaps, failed = failures.sample_renewal_gaps(
        failures.as_process(process, mtbf_s), key, n_runs, max_failures,
        n_nodes, device)
    return gaps.to(torch.float64), failed


# ---------------------------------------------------------------------------
# the float64 host oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenewalResult:
    """Per-epoch decisions + whole-run energy for a batch of renewal runs
    (float64 geometry and energies; ``decision`` is float32).  Epochs past a
    run's last failure (``valid`` False) hold placeholders."""

    decision: strategies.Decision
    valid: torch.Tensor        # (R, K) bool: epoch k occurred in run r
    gaps: torch.Tensor         # (R, K) balanced-execution gaps as evaluated
    t_fail: torch.Tensor       # (R, K) absolute (snapped) failure instants
    exec_rem: torch.Tensor     # (R, K, N) survivor work-to-rendezvous at failure
    t_failed: torch.Tensor     # (R, K, N) eq. 14 per epoch
    t_renewal: torch.Tensor    # (R, K) epoch duration T_E
    n_ckpt: torch.Tensor       # (R, K, N, F) planned checkpoints per ladder level
    failed_node: torch.Tensor  # (R, K) which node failed (labeling only)
    n_failures: torch.Tensor   # (R,)
    truncated: torch.Tensor    # (R,) bool: exhausted max_failures before makespan
    end_time: torch.Tensor     # (R,) wall end of the run (>= makespan)
    balanced_energy: torch.Tensor  # (R,) inter-failure + resync-ckpt + tail (J)
    epoch_ref: torch.Tensor    # (R, K, N) per-survivor epoch energy, reference
    epoch_int: torch.Tensor    # (R, K, N) per-survivor epoch energy, intervened
    epoch_failed: torch.Tensor  # (R, K) failed-node epoch energy (both runs)
    energy_ref: torch.Tensor   # (R,) whole-run reference energy
    energy_int: torch.Tensor   # (R,) whole-run intervened energy
    saving: torch.Tensor       # (R,) energy_ref - energy_int


def renewal_compose(cfg: ScenarioConfig, gaps, makespan_s: float,
                    failed_node=None, felled=None, device="cuda") -> RenewalResult:
    """Compose whole-run multi-failure energy analytically (float64 oracle).

    ``gaps`` (R, K) or (K,) are balanced-execution wall seconds between each
    renewal anchor and the next failure; epoch ``k`` of run ``r`` occurs iff
    the run is alive and ``bal_elapsed + gaps[r, k] <= makespan_s``; the
    first non-occurring epoch ends the run; ``truncated`` flags runs that
    used every gap with balanced time left.  ``felled`` ((R, K, N) bool or
    None) marks survivor slots additionally felled per epoch.  Semantics are
    the reference's, line for line; the geometry runs in float64 on
    ``device`` and Algorithm 1 once in float32 over every point.
    """
    dev = resolve_device(device)
    f8 = torch.float64
    _check_renewal_config(cfg)
    t8 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    gaps = torch.atleast_2d(torch.as_tensor(gaps).to(device=dev, dtype=f8))
    n_runs, max_failures = gaps.shape
    n = len(cfg.survivors)
    if felled is None:
        felled = torch.zeros((n_runs, max_failures, n), dtype=torch.bool,
                             device=dev)
    felled = torch.as_tensor(felled).to(device=dev, dtype=torch.bool).expand(
        n_runs, max_failures, n)
    pt = cfg.profile.power_table
    p_comp0, p_ckpt0 = float(pt.p_comp[0]), float(pt.p_ckpt[0])
    beta0, gamma0 = float(pt.beta[0]), float(pt.gamma[0])
    dur_fa = cfg.ckpt_duration * gamma0
    n_nodes = n + 1
    interval, dur = cfg.ckpt_interval, cfg.ckpt_duration
    period = t8([s.rendezvous_period for s in cfg.survivors])
    if failed_node is None:
        failed_node = torch.zeros((n_runs, max_failures), dtype=torch.int64,
                                  device=dev)
    failed_node = torch.as_tensor(failed_node).to(
        device=dev, dtype=torch.int64).expand(n_runs, max_failures)

    exec_anchor = t8([s.exec_to_rendezvous for s in cfg.survivors]).expand(
        n_runs, n).clone()
    ages = t8([s.ckpt_age for s in cfg.survivors]).expand(n_runs, n).clone()
    reexec_age = torch.full((n_runs,), float(cfg.t_reexec), dtype=f8, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=f8, device=dev)
    t_anchor, bal_elapsed, balanced = zeros(n_runs), zeros(n_runs), zeros(n_runs)
    alive = torch.ones(n_runs, dtype=torch.bool, device=dev)

    valid = torch.zeros((n_runs, max_failures), dtype=torch.bool, device=dev)
    t_fail = zeros(n_runs, max_failures)
    exec_rem_k = zeros(n_runs, max_failures, n)
    t_failed_k = zeros(n_runs, max_failures, n)
    t_renewal_k = zeros(n_runs, max_failures)
    n_ckpt_k = zeros(n_runs, max_failures, n, pt.num_levels)
    epoch_failed = zeros(n_runs, max_failures)
    ct_ref_k = zeros(n_runs, max_failures, n)
    beta = t8(pt.beta)
    neg_inf = torch.tensor(-torch.inf, dtype=f8, device=dev)

    for k in range(max_failures):
        delta = gaps[:, k]
        occurs = alive & (bal_elapsed + delta <= makespan_s)
        if not bool(occurs.any()):
            alive &= occurs
            continue
        age_f, work, _, d_eff = planning.advance_checkpoint_sawtooth(
            ages, delta[:, None], interval, dur)                 # (R, N)
        rem = torch.remainder(exec_anchor - work, period)
        exec_rem = torch.where(rem == 0.0, period, rem)
        reexec_f, _, _, d_eff_fail = planning.advance_checkpoint_sawtooth(
            reexec_age, delta, interval, dur)                    # (R,)
        m_k = felled[:, k]
        reexec_f = torch.maximum(
            reexec_f, torch.amax(torch.where(m_k, age_f, neg_inf), dim=-1))
        t_recover = cfg.t_down + cfg.t_restart + reexec_f
        t_failed = t_recover[:, None] + exec_rem

        # balanced span energy up to each node's (snapped) failure instant
        w_s, ck_s = planning.balanced_span(ages, d_eff, interval, dur)
        w_f, ck_f = planning.balanced_span(reexec_age, d_eff_fail, interval, dur)
        e_bal = (w_s * p_comp0 + ck_s * p_ckpt0).sum(dim=-1) \
            + w_f * p_comp0 + ck_f * p_ckpt0
        balanced = balanced + torch.where(
            occurs, e_bal + n_nodes * dur_fa * p_ckpt0, 0.0)

        plan = planning.checkpoint_plan(
            exec_rem, age_f, t_failed, interval=interval, dur=dur, beta=beta,
            gamma=None, move_ahead=cfg.move_ahead,
            move_frac=cfg.move_ahead_frac)
        p_star = torch.clamp_min(
            torch.amax(torch.where(m_k, neg_inf, exec_rem), dim=-1), 0.0)
        t_e = t_recover + p_star
        # failed node over [failure, T_E]: restart at P_ckpt + re-execution
        # and post-recovery serving at P_comp; each felled slot pays the same
        epoch_failed[:, k] = torch.where(
            occurs,
            (1.0 + m_k.sum(dim=-1))
            * (cfg.t_restart * p_ckpt0 + (reexec_f + p_star) * p_comp0), 0.0)

        valid[:, k] = occurs
        t_fail[:, k] = torch.where(occurs, t_anchor + d_eff_fail, 0.0)
        exec_rem_k[:, k] = exec_rem
        t_failed_k[:, k] = t_failed
        t_renewal_k[:, k] = torch.where(occurs, t_e, 0.0)
        n_ckpt_k[:, k] = plan.n_ckpt
        ct_ref_k[:, k] = exec_rem * beta0 + plan.n_ckpt[..., 0] * dur * gamma0

        # re-anchor: coordinated resync checkpoint -> ages 0, progress P*
        exec_next = post_recovery_anchor(exec_rem, period, p_star=p_star)
        exec_anchor = torch.where(occurs[:, None], exec_next, exec_anchor)
        ages = torch.where(occurs[:, None], 0.0, ages)
        reexec_age = torch.where(occurs, 0.0, reexec_age)
        bal_elapsed = torch.where(occurs, bal_elapsed + d_eff_fail, bal_elapsed)
        t_anchor = torch.where(occurs, t_fail[:, k] + t_e + dur_fa, t_anchor)
        alive &= occurs

    # balanced tail (mid-checkpoint snaps can nudge bal_elapsed past the
    # makespan; clamp)
    span = torch.clamp_min(makespan_s - bal_elapsed, 0.0)
    w_s, ck_s = planning.balanced_span(ages, span[:, None], interval, dur)
    w_f, ck_f = planning.balanced_span(reexec_age, span, interval, dur)
    balanced = balanced + (w_s * p_comp0 + ck_s * p_ckpt0).sum(dim=-1) \
        + w_f * p_comp0 + ck_f * p_ckpt0

    # --- one float32 Algorithm-1 dispatch over every (run, epoch, node) ----
    inp = sweep_inputs(cfg, torch.float32, dev)
    decision = strategies.evaluate_strategies_impl(
        exec_rem_k.to(torch.float32), t_failed_k.to(torch.float32),
        n_ckpt_k.to(torch.float32), inp.dur, inp.ladder, inp.sleep,
        inp.wait_mode, inp.p_idle_wait, mu1=inp.mu1, mu2=inp.mu2,
        per_level_n_ckpt=True)

    # per-survivor epoch energy = window energy + trailing fa span to T_E
    eni = decision.energy_reference.to(f8)
    ei = decision.energy_intervened.to(f8)
    ct_sel = decision.comp_time.to(f8)
    t_e3 = t_renewal_k[:, :, None]
    trail_ref = torch.clamp_min(
        t_e3 - torch.maximum(t_failed_k, ct_ref_k), 0.0) * p_comp0
    trail_int = torch.clamp_min(
        t_e3 - torch.maximum(t_failed_k, ct_sel), 0.0) * p_comp0
    v3 = valid[:, :, None] & ~felled
    epoch_ref = torch.where(v3, eni + trail_ref, 0.0)
    epoch_int = torch.where(v3, ei + trail_int, 0.0)

    energy_ref = balanced + epoch_ref.sum(dim=(1, 2)) + epoch_failed.sum(dim=1)
    energy_int = balanced + epoch_int.sum(dim=(1, 2)) + epoch_failed.sum(dim=1)
    return RenewalResult(
        decision=decision, valid=valid, gaps=gaps, t_fail=t_fail,
        exec_rem=exec_rem_k, t_failed=t_failed_k, t_renewal=t_renewal_k,
        n_ckpt=n_ckpt_k,
        failed_node=torch.where(valid, failed_node, -1),
        n_failures=valid.sum(dim=1),
        truncated=alive & (bal_elapsed < makespan_s),
        end_time=t_anchor + span,
        balanced_energy=balanced, epoch_ref=epoch_ref, epoch_int=epoch_int,
        epoch_failed=epoch_failed, energy_ref=energy_ref,
        energy_int=energy_int, saving=energy_ref - energy_int)


# ---------------------------------------------------------------------------
# engine="kernel": float32 composition with the Kahan ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenewalDeviceStats:
    """Whole-run quantities plus integer action counts, leading lane axis
    (scenarios or policies).  Tensors on the engine's device."""

    n_failures: torch.Tensor     # (S, R) int32
    truncated: torch.Tensor      # (S, R) bool
    end_time: torch.Tensor       # (S, R)
    balanced_energy: torch.Tensor  # (S, R)
    energy_ref: torch.Tensor     # (S, R)
    energy_int: torch.Tensor     # (S, R)
    saving: torch.Tensor         # (S, R)
    n_points: torch.Tensor       # (S, R) valid (epoch, survivor) points per run
    n_sleep: torch.Tensor        # (S, R) int32 counts over valid points
    n_min_freq: torch.Tensor
    n_comp_changed: torch.Tensor
    n_infeasible: torch.Tensor
    failed_counts: torch.Tensor  # (S, n_nodes) failures attributed per node


def _pack_kernel_inputs(stacked: SweepInputs, makespan_s):
    """Flatten a lane-stacked ``SweepInputs`` plus the per-lane makespan
    into the kernel's packed operands ``(params, nodes, ladder)`` (float32,
    on ``stacked``'s device).  The reference's ``_pack_pallas_inputs``."""
    from repro_torch.kernels import renewal_scan as rs

    dev = stacked.interval.device
    f4 = lambda x: torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    params = rs.pack_lane_params(
        interval=stacked.interval, dur=stacked.dur, reexec0=stacked.reexec0,
        t_down=stacked.t_down, t_restart=stacked.t_restart, mu1=stacked.mu1,
        mu2=stacked.mu2, wait_mode=stacked.wait_mode,
        p_idle_wait=stacked.p_idle_wait, move_ahead=stacked.move_ahead,
        move_frac=stacked.move_frac, makespan=f4(makespan_s),
        sleep=em.SleepArrays(**{f: f4(getattr(stacked.sleep, f))
                                for f in _SLEEP}),
        device=dev)
    nodes = torch.stack([f4(stacked.age0), f4(stacked.exec_rem0),
                         f4(stacked.period)], dim=1).contiguous()
    lad = stacked.ladder
    ladder = torch.stack([f4(getattr(lad, f)) for f in _LADDER],
                         dim=1).contiguous()
    return params, nodes, ladder


def _attach_failed_counts(out: dict, failed: torch.Tensor, n_nodes: int) -> dict:
    """Per-node failure counts over valid epochs, reduced over runs;
    ``out['valid']`` is (S|P, R, K) bool, ``failed`` (R, K)."""
    valid = out.pop("valid")
    node = torch.arange(n_nodes, device=valid.device)
    hit = valid[..., None] & (failed[None, ..., None] == node)
    out["failed_counts"] = hit.to(torch.int32).sum(dim=(1, 2))
    return out


def _check_kernel_call(engine: str, stats: bool, topology) -> None:
    if engine in ("scan", "device"):
        raise _not_in_slice(f"engine={engine!r} (the f64 scan engine)")
    if engine != "kernel":
        raise ValueError(f"unknown engine {engine!r} (use 'kernel')")
    if not stats:
        raise ValueError("engine='kernel' is the stats-only hot path; the "
                         "per-epoch diagnostic view is the scan engine's")
    if topology is not None:
        raise _not_in_slice("the correlated topology= sampler")


def _renewal_kernel_mc(stacked: SweepInputs, key, makespan_s, process,
                       n_runs: int, max_failures: int,
                       compensated: bool = True) -> RenewalDeviceStats:
    """Sampling (shared across lanes — common random numbers) plus the
    packed float32 composition through ``kernels.renewal_scan``."""
    from repro_torch.kernels import renewal_scan as rs

    dev = stacked.interval.device
    n_nodes = stacked.period.shape[-1] + 1
    gaps32, failed = failures.sample_renewal_gaps(
        process, key, n_runs, max_failures, n_nodes, dev)
    params, nodes, ladder = _pack_kernel_inputs(stacked, makespan_s)
    out = rs.renewal_scan(params, nodes, ladder, gaps32.T.contiguous(),
                          compensated=compensated)
    out["valid"] = out["valid"].transpose(1, 2).bool()
    out["truncated"] = out["truncated"].bool()
    out = _attach_failed_counts(out, failed, n_nodes)
    return RenewalDeviceStats(**out)


def renewal_monte_carlo_device(cfgs, key, *, n_runs: int = 256,
                               makespan_s: float = 30 * 24 * 3600.0,
                               mtbf_s: float = 14 * 24 * 3600.0,
                               max_failures: int = 64, stats: bool = True,
                               process: Optional[failures.FailureProcess] = None,
                               topology=None, engine: str = "kernel",
                               device="cuda") -> RenewalDeviceStats:
    """Whole-run Monte-Carlo for stacked scenarios in one kernel launch:
    sampling on ``device``, then the float32 Kahan-ledger composition.
    Returns the lean ``RenewalDeviceStats`` (the kernel is stats-only)."""
    _check_kernel_call(engine, stats, topology)
    dev = resolve_device(device)
    proc = failures.as_process(process, mtbf_s)
    _, stacked = _renewal_device_inputs(cfgs, torch.float32, dev)
    return _renewal_kernel_mc(stacked, key, float(makespan_s), proc,
                              n_runs, max_failures)


def renewal_monte_carlo_policies(stacked: SweepInputs, key, *, makespan_s,
                                 n_runs: int = 256, max_failures: int = 32,
                                 mtbf_s: Optional[float] = None,
                                 process: Optional[failures.FailureProcess] = None,
                                 stats: bool = True, topology=None,
                                 engine: str = "kernel") -> RenewalDeviceStats:
    """Whole-run Monte-Carlo over a policy-stacked ``SweepInputs`` (leading
    policy axis P, per-policy ``makespan_s``) in one kernel launch, on the
    device ``stacked`` lies on.  The sampler never sees the policy axis, so
    every lane meets the same histories (common random numbers)."""
    _check_kernel_call(engine, stats, topology)
    if stacked.interval.dim() != 1:
        raise _not_in_slice("the cluster axis (clusters=)")
    proc = failures.as_process(process, mtbf_s)
    return _renewal_kernel_mc(stacked, key, makespan_s, proc, n_runs,
                              max_failures)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenewalMonteCarloSummary:
    """Whole-run expectation view of a scenario under repeated failures."""

    n_runs: int
    makespan_s: float
    mtbf_s: float               # per-node MTBF
    max_failures: int
    mean_failures: float
    failure_count_hist: dict    # n_failures -> fraction of runs
    per_node_failures: tuple    # mean failures per node over the makespan
    truncated_rate: float       # runs that hit max_failures before makespan
    mean_energy_ref_j: float
    mean_energy_int_j: float
    mean_saving_j: float
    p5_saving_j: float
    p95_saving_j: float
    mean_saving_pct: float      # 100 * E[saving] / E[reference energy]
    sleep_occupancy: float
    min_freq_rate: float
    comp_change_rate: float
    infeasible_rate: float
    annual_saving_j: float


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assemble_summary(*, counts, per_node, truncated, energy_ref, energy_int,
                      saving, sleep_occupancy, min_freq_rate,
                      comp_change_rate, infeasible_rate, n_runs: int,
                      makespan_s: float, mtbf_s: float,
                      max_failures: int) -> RenewalMonteCarloSummary:
    """The one ``RenewalMonteCarloSummary`` construction behind both
    engines (host float64 numpy)."""
    counts = _np(counts)
    energy_ref = _np(energy_ref).astype(np.float64)
    saving = _np(saving).astype(np.float64)
    mean_ref = float(energy_ref.mean())
    mean_saving = float(saving.mean())
    return RenewalMonteCarloSummary(
        n_runs=n_runs,
        makespan_s=float(makespan_s),
        mtbf_s=float(mtbf_s),
        max_failures=max_failures,
        mean_failures=float(counts.mean()),
        failure_count_hist={
            int(c): float(np.mean(counts == c)) for c in np.unique(counts)},
        per_node_failures=tuple(per_node),
        truncated_rate=float(np.mean(_np(truncated).astype(bool))),
        mean_energy_ref_j=mean_ref,
        mean_energy_int_j=float(_np(energy_int).astype(np.float64).mean()),
        mean_saving_j=mean_saving,
        p5_saving_j=float(np.percentile(saving, 5)),
        p95_saving_j=float(np.percentile(saving, 95)),
        mean_saving_pct=float(100.0 * mean_saving / max(mean_ref, 1e-9)),
        sleep_occupancy=sleep_occupancy,
        min_freq_rate=min_freq_rate,
        comp_change_rate=comp_change_rate,
        infeasible_rate=infeasible_rate,
        annual_saving_j=mean_saving * SECONDS_PER_YEAR / float(makespan_s),
    )


def _renewal_summary(*, valid, failed_node, truncated, energy_ref, energy_int,
                     saving, wait_action, comp_changed, feasible_any,
                     n_survivors: int, n_runs: int, makespan_s: float,
                     mtbf_s: float, max_failures: int,
                     felled=None) -> RenewalMonteCarloSummary:
    """Reduce one scenario's (R, K[, N]) host-oracle arrays to expectations
    (rates as means over valid, non-felled decision points)."""
    valid = _np(valid).astype(bool)
    counts = valid.sum(axis=1)
    failed_node = _np(failed_node)
    per_node = tuple(
        float(np.mean(np.sum((failed_node == m) & valid, axis=1)))
        for m in range(n_survivors + 1))
    v = valid[:, :, None] & np.ones(n_survivors, bool)
    if felled is not None:
        v = v & ~_np(felled).astype(bool)
    pts = v.nonzero()
    actions = _np(wait_action)[pts] if v.any() else np.array([])
    pick = lambda a: _np(a)[pts]
    rate = lambda x: float(np.mean(x)) if actions.size else 0.0
    return _assemble_summary(
        counts=counts, per_node=per_node, truncated=truncated,
        energy_ref=energy_ref, energy_int=energy_int, saving=saving,
        sleep_occupancy=rate(actions == em.WaitAction.SLEEP),
        min_freq_rate=rate(actions == em.WaitAction.MIN_FREQ),
        comp_change_rate=rate(pick(comp_changed)) if actions.size else 0.0,
        infeasible_rate=rate(~pick(feasible_any).astype(bool))
        if actions.size else 0.0,
        n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
        max_failures=max_failures)


def _stats_to_host(stats: RenewalDeviceStats) -> dict:
    """One host transfer of every stats field."""
    return {f.name: _np(getattr(stats, f.name))
            for f in dataclasses.fields(stats)}


def _summarize_device_scenario(stats: dict, s: int, n_runs: int,
                               makespan_s: float, mtbf_s: float,
                               max_failures: int) -> RenewalMonteCarloSummary:
    """Summary of lane ``s`` from host copies of the lean stats — rates
    rebuilt from the integer counts (exactly the oracle's means)."""
    n_pts = int(stats["n_points"][s].sum())
    rate = ((lambda c: float(np.int64(c[s].sum()) / n_pts)) if n_pts
            else (lambda c: 0.0))
    return _assemble_summary(
        counts=stats["n_failures"][s],
        per_node=(float(c) / n_runs for c in stats["failed_counts"][s]),
        truncated=stats["truncated"][s].astype(bool),
        energy_ref=stats["energy_ref"][s].astype(np.float64),
        energy_int=stats["energy_int"][s].astype(np.float64),
        saving=stats["saving"][s].astype(np.float64),
        sleep_occupancy=rate(stats["n_sleep"]),
        min_freq_rate=rate(stats["n_min_freq"]),
        comp_change_rate=rate(stats["n_comp_changed"]),
        infeasible_rate=rate(stats["n_infeasible"]),
        n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
        max_failures=max_failures)


def renewal_monte_carlo(cfg: ScenarioConfig, key, n_runs: int = 256,
                        makespan_s: float = 30 * 24 * 3600.0,
                        mtbf_s: float = 14 * 24 * 3600.0,
                        max_failures: int = 64, engine: str = "kernel",
                        process: Optional[failures.FailureProcess] = None,
                        topology=None, device="cuda") -> RenewalMonteCarloSummary:
    """Monte-Carlo whole-run energy under per-node failure processes.

    ``engine="kernel"`` runs the float32 Kahan-ledger composition
    (``renewal_monte_carlo_device``); ``engine="host"`` the float64 oracle
    (``renewal_compose``) on the same histories, reduced by the same
    summary code.  With a ``process`` the summary's ``mtbf_s`` reports the
    process's mean gap.
    """
    if engine in ("device", "scan"):
        raise _not_in_slice(f"engine={engine!r} (the f64 scan engine)")
    if topology is not None:
        raise _not_in_slice("the correlated topology= sampler")
    dev = resolve_device(device)
    if process is not None:
        mtbf_s = float(np.mean(failures.as_process(process).mean_s()))
    kw = dict(n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
              max_failures=max_failures)
    if engine == "kernel":
        res = renewal_monte_carlo_device(cfg, key, process=process,
                                         device=dev, **kw)
        return _summarize_device_scenario(_stats_to_host(res), 0, **kw)
    if engine != "host":
        raise ValueError(f"unknown engine {engine!r} (use 'kernel' or 'host')")
    n_nodes = len(cfg.survivors) + 1
    gaps, failed = renewal_failure_gaps(key, n_runs, n_nodes, max_failures,
                                        mtbf_s, process=process, device=dev)
    res = renewal_compose(cfg, gaps, makespan_s, failed_node=failed, device=dev)
    return _renewal_summary(
        valid=res.valid, failed_node=res.failed_node, truncated=res.truncated,
        energy_ref=res.energy_ref, energy_int=res.energy_int,
        saving=res.saving, wait_action=res.decision.wait_action,
        comp_changed=res.decision.comp_changed,
        feasible_any=res.decision.feasible_any,
        n_survivors=len(cfg.survivors), **kw)


def renewal_monte_carlo_scenarios(cfgs: Sequence[ScenarioConfig], key,
                                  n_runs: int = 256,
                                  makespan_s: float = 30 * 24 * 3600.0,
                                  mtbf_s: float = 14 * 24 * 3600.0,
                                  max_failures: int = 64,
                                  process: Optional[failures.FailureProcess] = None,
                                  topology=None, engine: str = "kernel",
                                  device="cuda") -> dict:
    """name -> ``RenewalMonteCarloSummary`` for stacked scenarios from ONE
    kernel launch; every scenario sees the same sampled histories."""
    cfg_list = list(cfgs)
    if process is not None:
        mtbf_s = float(np.mean(failures.as_process(process).mean_s()))
    kw = dict(n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
              max_failures=max_failures)
    res = _stats_to_host(renewal_monte_carlo_device(
        cfg_list, key, process=process, topology=topology, engine=engine,
        device=device, **kw))
    return {cfg.name: _summarize_device_scenario(res, s, **kw)
            for s, cfg in enumerate(cfg_list)}
