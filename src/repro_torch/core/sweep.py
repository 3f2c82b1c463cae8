"""Failure-time sweeps and the renewal Monte-Carlo, on torch tensors.

Counterpart of ``repro.core.sweep``.  Two halves:

The single-failure sweep (the paper's "different configurations and
failure time").  ``sweep_failure_times``/``sweep_scenarios`` evaluate
Algorithm 1 over a whole ``(scenario x) (mu-band x) failure time x
survivor`` grid in one call: each survivor's state at each shifted
failure instant comes from the checkpoint and rendezvous sawtooths in
closed form (``planning``), so no event stepping.  ``summarize`` and
``monte_carlo`` (sampled failure instants, float64 arrival cumsum folded
into a wrap window) reduce it on the host.

The renewal Monte-Carlo: whole-run energy across repeated failures.  Three
engines share one sampler, so for a fixed key they see the same failure
histories:

  * ``engine="scan"`` (the default, the reference's ``"scan"``/
    ``"device"``) — ``_renewal_scan``: the epoch recursion in float64 as a
    Python loop over the K epochs, vectorised over (lane, run), then the
    balanced-span energy, the checkpoint plan, one float32 Algorithm-1 fold
    over every point and the trailing spans, vectorised over the stacked
    epochs.  ``stats=True`` returns the lean ``RenewalDeviceStats``,
    ``stats=False`` the per-epoch ``RenewalDeviceResult``.  The reference's
    ``_renewal_device_core``/``_renewal_policy_core`` (vmaps over runs and
    lanes) need no counterpart here: one scan takes a scenario stack with
    one makespan or a policy stack with a makespan per lane.  Every sum
    over epochs and nodes is a fixed pairwise tree, so a lane's bits do not
    depend on the lanes beside it or on the device.
  * ``engine="kernel"`` (the reference's ``"pallas"``) — the float32
    composition with the Kahan-compensated ledger,
    ``kernels.renewal_scan.renewal_scan``: the hand-written CUDA kernel on a
    card, its plain PyTorch version on the CPU.  Stats only.
  * ``engine="host"`` — ``renewal_compose``, the float64 oracle: a Python
    loop over failure epochs with float64 geometry plus one float32
    Algorithm-1 dispatch over every (run, epoch, survivor) point.  It
    shares no code with ``_renewal_scan`` beyond the closed forms, so the
    two check each other.

Every engine takes a ``core.topology.Topology`` (``topology=``): the
correlated shock sampler then draws the histories and the felled survivor
slots of each epoch, which every engine composes.

The cluster axis (``renewal_monte_carlo_policies`` on a ``(C, P)``
stack, the fleet dispatch): each cluster lane samples its own histories at
the shared key through its own process parameters, in one batched pass,
and one float64 scan runs over the ``C x P`` lanes.

Semantics (snapping, chain order, occurrence, truncation, re-anchoring,
the quiesce policy) are the reference's; see its module and docs/sweep.md.
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
from repro_torch.core import prng
from repro_torch.core import strategies
from repro_torch.core import topology as node_topology
from repro_torch.core.scenarios import post_recovery_anchor
from repro_torch.core.simulator import ScenarioConfig

__all__ = [
    "SweepInputs",
    "SweepResult",
    "SweepSummary",
    "MonteCarloSummary",
    "RenewalResult",
    "RenewalDeviceResult",
    "RenewalDeviceStats",
    "RenewalMonteCarloSummary",
    "sweep_inputs",
    "inputs_from_reference",
    "sweep_failure_times",
    "sweep_scenarios",
    "summarize",
    "exponential_failure_offsets",
    "failure_offsets",
    "monte_carlo",
    "renewal_failure_gaps",
    "renewal_compose",
    "renewal_compose_device",
    "renewal_compose_policies",
    "renewal_monte_carlo_device",
    "renewal_monte_carlo",
    "renewal_monte_carlo_scenarios",
    "renewal_monte_carlo_policies",
]

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def _map_leaves(fn, inputs: Sequence[SweepInputs]) -> SweepInputs:
    """``SweepInputs`` whose every array leaf is ``fn`` of the list of that
    leaf across ``inputs``; ``peer`` is the first input's."""
    leaf = lambda get: fn([get(i) for i in inputs])
    return SweepInputs(
        **{f: leaf(lambda i, _f=f: getattr(i, _f)) for f in _LEAVES},
        ladder=em.LadderArrays(**{f: leaf(lambda i, _f=f: getattr(i.ladder, _f))
                                  for f in _LADDER}),
        sleep=em.SleepArrays(**{f: leaf(lambda i, _f=f: getattr(i.sleep, _f))
                                for f in _SLEEP}),
        peer=inputs[0].peer)


def _stack(inputs: Sequence[SweepInputs]) -> SweepInputs:
    return _map_leaves(torch.stack, inputs)


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
# the single-failure grid (one call per scenario stack)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Per-grid-point decisions + geometry.

    Geometry is ``(T, N)`` for one scenario and ``(S, T, N)`` for a stack
    (``t_reexec`` drops the node axis, ``n_ckpt`` adds the ladder axis);
    ``decision`` fields gain a mu-band axis before ``T`` — ``(M, T, N)``,
    ``(S, M, T, N)`` — except the mu-independent ``energy_reference`` and
    ``feasible_any``, which keep the geometry's shape.
    """

    decision: strategies.Decision
    exec_rem: torch.Tensor     # work to rendezvous at the failure instant
    ckpt_age: torch.Tensor
    delta_eff: torch.Tensor    # per-node snapped failure instant
    t_reexec: torch.Tensor     # (..., T)
    t_failed: torch.Tensor     # eq. 14
    n_ckpt: torch.Tensor       # (..., T, N, F) planned checkpoints per ladder level
    plan_move: torch.Tensor    # move-ahead planned
    chain_ok: torch.Tensor     # chained-rendezvous ordering holds


def _sweep_core(inp: SweepInputs, offsets: torch.Tensor,
                band: Optional[torch.Tensor] = None) -> SweepResult:
    """Algorithm 1 at every failure offset.  ``inp`` is one scenario's
    float32 inputs (scalar leaves ``()``) or a stack (leading ``S``);
    ``offsets`` is ``(T,)``; ``band`` is ``None`` (each scenario's own
    ``mu1``), a scalar ``mu1`` for every scenario, or a mu-band ``(M,)``.
    The whole grid is one set of launches: the only Python loops run over
    the chain order (static structure) and, inside the Algorithm-1 fold,
    the F ladder levels."""
    stacked = inp.interval.dim() > 0
    sc = lambda x: x.reshape(x.shape + (1, 1))     # scalar leaf vs (..., T, N)
    s1 = lambda x: x.unsqueeze(-1)                 # scalar leaf vs (..., T)
    nd = lambda x: x.unsqueeze(-2)                 # node leaf vs (..., T, N)
    age, work, _, delta_eff = planning.advance_checkpoint_sawtooth(
        nd(inp.age0), offsets[:, None], sc(inp.interval), sc(inp.dur))
    rem = torch.remainder(nd(inp.exec_rem0) - work, nd(inp.period))
    exec_rem = torch.where(rem == 0.0, nd(inp.period), rem)     # (0, period]
    t_reexec, _, _, _ = planning.advance_checkpoint_sawtooth(
        s1(inp.reexec0), offsets, s1(inp.interval), s1(inp.dur))
    t_recover = s1(inp.t_down) + s1(inp.t_restart) + t_reexec     # eq. 15

    # rendezvous-completion times in chain (topological) order: direct
    # blockers wait for the recovering process (eq. 14); chained blockers
    # wait for their peer to resume and reach the shared progress point.
    cols, ok = [], []
    for i, p in enumerate(inp.peer):
        if p == 0:
            cols.append(t_recover + exec_rem[..., i])
            ok.append(torch.ones_like(exec_rem[..., i], dtype=torch.bool))
        else:
            cols.append(cols[p - 1] + (exec_rem[..., i] - exec_rem[..., p - 1]))
            ok.append(exec_rem[..., i] > exec_rem[..., p - 1])
    t_failed = torch.stack(cols, dim=-1)
    chain_ok = torch.stack(ok, dim=-1)

    plan = planning.checkpoint_plan(
        exec_rem, age, t_failed, interval=sc(inp.interval), dur=sc(inp.dur),
        beta=nd(nd(inp.ladder.beta)), gamma=None,
        move_ahead=sc(inp.move_ahead), move_frac=sc(inp.move_frac))

    # Algorithm 1 as the ladder fold (the vectorized form's arithmetic, op
    # for op, without the (..., F) intermediates), ladder axis first.  A
    # stack with a mu-band evaluates (S, 1, T, N) nodes against (M, 1, 1)
    # margins.
    banded = band is not None and band.dim() == 1
    lift = (lambda x: x.unsqueeze(1)) if banded and stacked else (lambda x: x)
    extra = 1 if banded and stacked else 0
    bs = lambda x: x.reshape(x.shape + (1,) * (2 + extra))
    ladder = em.LadderArrays(**{
        f: bs(getattr(inp.ladder, f).movedim(-1, 0)) for f in _LADDER})
    sleep = em.SleepArrays(**{f: bs(getattr(inp.sleep, f)) for f in _SLEEP})
    if band is None:
        mu1 = bs(inp.mu1)
    else:
        mu1 = band.reshape(-1, 1, 1) if banded else band
    n_ckpt = lift(plan.n_ckpt)
    decision = strategies.evaluate_strategies_fold(
        lift(exec_rem), lift(t_failed),
        [n_ckpt[..., f] for f in range(ladder.num_levels)], bs(inp.dur),
        ladder, sleep, bs(inp.wait_mode), bs(inp.p_idle_wait), mu1=mu1,
        mu2=bs(inp.mu2))
    if banded and stacked:
        decision = dataclasses.replace(
            decision, energy_reference=decision.energy_reference.squeeze(1),
            feasible_any=decision.feasible_any.squeeze(1))
    return SweepResult(
        decision=decision, exec_rem=exec_rem, ckpt_age=age,
        delta_eff=delta_eff, t_reexec=t_reexec, t_failed=t_failed,
        n_ckpt=plan.n_ckpt, plan_move=plan.plan_move, chain_ok=chain_ok)


def _mu_band(mu1, device) -> torch.Tensor:
    """A scalar margin (``()``) or a mu-band (``(M,)``), float32 on
    ``device``."""
    mu1 = torch.as_tensor(mu1, dtype=torch.float32, device=device)
    if mu1.dim() > 1:
        raise ValueError(f"mu1 must be a scalar or a 1-d band, got {tuple(mu1.shape)}")
    return mu1


def _offsets(offsets, device) -> torch.Tensor:
    return torch.as_tensor(offsets).to(device=device, dtype=torch.float32)


def sweep_failure_times(cfg: ScenarioConfig, offsets, mu1=None,
                        device="cuda") -> SweepResult:
    """Dense failure-time sweep of one scenario in one call on ``device``.

    ``offsets`` are wall seconds after the scenario's reference failure
    instant, shape (T,).  ``mu1=None`` uses the scenario's own sleep-gate
    margin; an (M,) array sweeps the mu-band, giving decisions (M, T, N).
    """
    dev = resolve_device(device)
    band = None if mu1 is None else _mu_band(mu1, dev)
    return _sweep_core(sweep_inputs(cfg, device=dev), _offsets(offsets, dev),
                       band)


def sweep_scenarios(cfgs: Sequence[ScenarioConfig], offsets, mu1=None,
                    device="cuda") -> SweepResult:
    """Stacked sweep over scenarios: the whole (scenario x failure time x
    node x ladder) grid in one call on ``device``, results with a leading
    scenario axis.  The scenarios must share survivor count, ladder size
    and blocking topology (the Table-4 six do); per-scenario wait modes,
    margins and ladders ride along.  ``mu1=None`` uses each scenario's own
    margin; an (M,) band gives decisions (S, M, T, N)."""
    dev = resolve_device(device)
    inputs = [sweep_inputs(c, device=dev) for c in cfgs]
    peers = {i.peer for i in inputs}
    if len(peers) != 1:
        raise ValueError(f"scenarios have mixed blocking topologies: {peers}")
    shapes = {(tuple(i.exec_rem0.shape), tuple(i.ladder.beta.shape))
              for i in inputs}
    if len(shapes) != 1:
        raise ValueError(f"stacked scenarios must share survivor count and "
                         f"ladder size (got {shapes})")
    band = None if mu1 is None else _mu_band(mu1, dev)
    return _sweep_core(_stack(inputs), _offsets(offsets, dev), band)


# ---------------------------------------------------------------------------
# summary statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepSummary:
    """Distributional view of one scenario's sweep (floats, host-side)."""

    points: int                 # grid points (T * N)
    mean_saving_j: float        # per-node saving, eq. (1)
    p5_saving_j: float
    p95_saving_j: float
    mean_saving_pct: float
    sleep_occupancy: float      # fraction of points the sleep gate admitted
    min_freq_rate: float
    comp_change_rate: float
    infeasible_rate: float      # no ladder level feasible -> no intervention
    mean_wait_s: float
    chain_violation_rate: float  # chained-rendezvous ordering broken (see chain_ok)


def summarize(res: SweepResult) -> SweepSummary:
    """Reduce a sweep (any batch shape) to summary statistics on the host.

    Points where a chained survivor wrapped past its peer (``chain_ok``
    False) carry meaningless savings: they are excluded from every
    statistic and reported only through ``chain_violation_rate``.
    ``points`` counts the full grid; the other fields are over the
    chain-valid subset (NaN when nothing is valid).
    """
    d = res.decision
    saving = _np(d.saving).astype(np.float64)
    chain_ok = _np(res.chain_ok).astype(bool)
    # decision arrays may carry extra leading batch dims (a mu-band) that
    # the geometry and the mu-independent fields do not
    ok = np.broadcast_to(chain_ok, saving.shape)
    valid = ok.reshape(-1)
    pick = lambda a: np.broadcast_to(_np(a), ok.shape).reshape(-1)[valid]
    saving = saving.reshape(-1)[valid]
    actions = pick(d.wait_action)
    violation = float(np.mean(~chain_ok))
    if saving.size == 0:
        nan = float("nan")
        return SweepSummary(
            points=int(ok.size), mean_saving_j=nan, p5_saving_j=nan,
            p95_saving_j=nan, mean_saving_pct=nan, sleep_occupancy=nan,
            min_freq_rate=nan, comp_change_rate=nan, infeasible_rate=nan,
            mean_wait_s=nan, chain_violation_rate=violation)
    return SweepSummary(
        points=int(ok.size),
        mean_saving_j=float(saving.mean()),
        p5_saving_j=float(np.percentile(saving, 5)),
        p95_saving_j=float(np.percentile(saving, 95)),
        mean_saving_pct=float(pick(d.saving_pct).mean()),
        sleep_occupancy=float(np.mean(actions == em.WaitAction.SLEEP)),
        min_freq_rate=float(np.mean(actions == em.WaitAction.MIN_FREQ)),
        comp_change_rate=float(np.mean(pick(d.comp_changed))),
        infeasible_rate=float(np.mean(~pick(d.feasible_any))),
        mean_wait_s=float(pick(d.wait_time).mean()),
        chain_violation_rate=violation,
    )


# ---------------------------------------------------------------------------
# Monte-Carlo over sampled failure instants
# ---------------------------------------------------------------------------

def exponential_failure_offsets(key, n_samples: int, mtbf_s: float,
                                wrap_s: float, device="cuda") -> np.ndarray:
    """Failure offsets of a Poisson failure process with the given MTBF:
    unit-exponential draws from ``key`` on ``device``, arrival times
    accumulated on the host in float64 and folded into ``[0, wrap_s)``
    (float32 offsets, the sweep's dtype)."""
    gaps = prng.exponential(key, (n_samples,), device).cpu().numpy()
    arrivals = np.cumsum(gaps.astype(np.float64) * float(mtbf_s))
    return np.mod(arrivals, float(wrap_s)).astype(np.float32)


def failure_offsets(key, n_samples: int, process: failures.FailureProcess,
                    wrap_s: float, device="cuda") -> np.ndarray:
    """``exponential_failure_offsets`` for any renewal arrival process: one
    cluster-level stream of unconditional float32 gap draws (scalar process
    parameters only), accumulated in float64 and folded as above."""
    if np.size(process.mean_s()) != 1:
        raise ValueError(
            "failure_offsets samples one cluster-level arrival stream; "
            "per-node heterogeneous parameters belong to the renewal "
            "engines (renewal_failure_gaps / renewal_monte_carlo)")
    gaps = process.sample(key, (n_samples,), device).cpu().numpy()
    arrivals = np.cumsum(gaps.astype(np.float64))
    return np.mod(arrivals, float(wrap_s)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MonteCarloSummary:
    """Expected-value view of a scenario under a failure distribution."""

    n_samples: int
    mtbf_s: float
    failures_per_year: float
    # per-failure totals over all survivors (J)
    mean_saving_j: float
    p5_saving_j: float
    p95_saving_j: float
    mean_saving_pct: float
    # action occupancy over (sample, node) points
    sleep_occupancy: float
    min_freq_rate: float
    comp_change_rate: float
    infeasible_rate: float
    # expected annual savings (J/year), total and per strategy family
    annual_saving_j: float
    annual_saving_by_strategy: dict


def _monte_carlo_summary(cfg: ScenarioConfig, offsets, mtbf_s: float, mu1,
                         device) -> MonteCarloSummary:
    """The sweep at sampled ``offsets`` reduced to expectations (host
    float64); ``monte_carlo`` without the sampling."""
    res = sweep_failure_times(cfg, offsets, mu1=mu1, device=device)
    chain_ok = _np(res.chain_ok).astype(bool)
    if not chain_ok.all():
        # savings at chain-broken instants are meaningless: refuse to
        # average them into expectations (as shift_failure refuses)
        raise ValueError(
            f"{cfg.name}: {float(np.mean(~chain_ok)):.1%} of sampled failure "
            "instants break the chained-rendezvous ordering; Monte-Carlo "
            "expectations are not defined for this blocking topology")
    d = res.decision
    saving = _np(d.saving).astype(np.float64)           # (T, N)
    eni = _np(d.energy_reference).astype(np.float64)
    actions = _np(d.wait_action)
    comp_changed = _np(d.comp_changed)
    per_failure = saving.sum(axis=-1)                   # (T,)
    failures_per_year = SECONDS_PER_YEAR / float(mtbf_s)
    mean_saving = float(per_failure.mean())
    masks = {
        "sleep": actions == em.WaitAction.SLEEP,
        "min_freq": actions == em.WaitAction.MIN_FREQ,
        "comp_change_only": (actions == em.WaitAction.NONE) & comp_changed,
    }
    by_strategy = {
        name: float((saving * mask).sum(axis=-1).mean() * failures_per_year)
        for name, mask in masks.items()
    }
    return MonteCarloSummary(
        n_samples=int(saving.shape[0]),
        mtbf_s=float(mtbf_s),
        failures_per_year=failures_per_year,
        mean_saving_j=mean_saving,
        p5_saving_j=float(np.percentile(per_failure, 5)),
        p95_saving_j=float(np.percentile(per_failure, 95)),
        mean_saving_pct=float(100.0 * per_failure.sum() / max(eni.sum(), 1e-9)),
        sleep_occupancy=float(np.mean(masks["sleep"])),
        min_freq_rate=float(np.mean(masks["min_freq"])),
        comp_change_rate=float(np.mean(comp_changed)),
        infeasible_rate=float(np.mean(~_np(d.feasible_any))),
        annual_saving_j=mean_saving * failures_per_year,
        annual_saving_by_strategy=by_strategy,
    )


def monte_carlo(cfg: ScenarioConfig, key, n_samples: int = 4096,
                mtbf_s: float = 30 * 24 * 3600.0,
                wrap_s: Optional[float] = None, mu1=None,
                process: Optional[failures.FailureProcess] = None,
                device="cuda") -> MonteCarloSummary:
    """Monte-Carlo expectation of the paper's strategies under sampled
    failure times (one node failing per event, as in the paper): the
    sampled instants go through the sweep in one call, and the summary
    scales the per-failure mean by the expected failure count.  The
    ``by_strategy`` split attributes each point's saving to the selected
    action family (a frequency change with a wait action counts toward the
    wait action, as Table 4 labels it).  ``process=None`` keeps the
    paper's exponential arrivals at ``mtbf_s``; another process drives the
    stream through ``failure_offsets`` and its mean gap replaces
    ``mtbf_s``.  Deterministic for a fixed ``key`` and device.
    """
    dev = resolve_device(device)
    if wrap_s is None:
        wrap_s = 64.0 * (cfg.ckpt_interval + cfg.ckpt_duration)
    if process is None:
        offsets = exponential_failure_offsets(key, n_samples, mtbf_s, wrap_s,
                                              dev)
    else:
        offsets = failure_offsets(key, n_samples, process, wrap_s, dev)
        mtbf_s = float(np.mean(process.mean_s()))
    return _monte_carlo_summary(cfg, offsets, mtbf_s, mu1, dev)


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
    sampler's gaps, so every engine sees the same histories for a key.

    A ``core.topology.Topology`` switches to the correlated shock sampler
    and the return becomes the reference's triple ``(gaps, failed_node,
    failed_mask)``: ``failed_node`` is each epoch's primary (int32) and
    ``failed_mask`` ((n_runs, max_failures, n_nodes) bool) marks every
    node felled in the epoch; ``topology.survivor_slot_mask`` maps it to
    ``renewal_compose``'s ``felled``."""
    if process is None and mtbf_s is None:
        raise ValueError("provide mtbf_s or a FailureProcess")
    proc = failures.as_process(process, mtbf_s)
    if topology is not None:
        gaps, fmask, primary = node_topology.sample_correlated_renewal_gaps(
            topology, proc, key, n_runs, max_failures, n_nodes, device)
        return gaps.to(torch.float64), primary, fmask
    gaps, failed = failures.sample_renewal_gaps(
        proc, key, n_runs, max_failures, n_nodes, device)
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
# the device engines: the float64 scan and the float32 kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenewalDeviceResult:
    """Per-epoch view of the scan engine, leading lane axis (scenarios or
    policies).  ``decision`` fields are ``(S, R, K, N)`` float32 (the host
    oracle's dispatch, op for op), geometry and energies float64; ``gaps``
    ``(R, K)`` is shared by every lane.  Epochs with ``valid`` False hold
    placeholders and are excluded from every total."""

    decision: strategies.Decision
    valid: torch.Tensor          # (S, R, K) bool
    gaps: torch.Tensor           # (R, K) balanced-execution gaps as evaluated
    t_fail: torch.Tensor         # (S, R, K) absolute (snapped) failure instants
    exec_rem: torch.Tensor       # (S, R, K, N)
    t_failed: torch.Tensor       # (S, R, K, N) eq. 14 per epoch
    t_renewal: torch.Tensor      # (S, R, K) epoch duration T_E
    failed_node: torch.Tensor    # (S, R, K) which node failed (labeling only)
    n_failures: torch.Tensor     # (S, R)
    truncated: torch.Tensor      # (S, R) bool
    end_time: torch.Tensor       # (S, R)
    balanced_energy: torch.Tensor  # (S, R)
    epoch_ref: torch.Tensor      # (S, R, K, N)
    epoch_int: torch.Tensor      # (S, R, K, N)
    epoch_failed: torch.Tensor   # (S, R, K)
    energy_ref: torch.Tensor     # (S, R)
    energy_int: torch.Tensor     # (S, R)
    saving: torch.Tensor         # (S, R)


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


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two, then halved): the same bits for every leading shape and
    on every device, unlike a library reduction whose order may follow the
    output count."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _renewal_scan(inp: SweepInputs, gaps: torch.Tensor, makespan_s,
                  stats: bool = False, felled=None) -> dict:
    """Whole-run renewal recursion for every (lane, run) in float64.

    ``inp`` is a lane-stacked ``SweepInputs`` (scenarios or policies,
    leading axis P; any float dtype, cast to float64 here), ``gaps`` (R, K)
    float64 shared by every lane or (P, R, K) one history per lane (the
    cluster axis), ``makespan_s`` a scalar or (P,), and
    ``felled`` None or an (R, K, N) survivor-slot mask.  A Python loop over
    the K epochs carries only the re-anchor recursion ``(ages, exec_anchor,
    bal_elapsed, t_anchor, alive)`` — the failed node's lost-work age rides
    as node N of the ages — vectorised over (P, R).  The balanced-span
    energy, the checkpoint plan, one float32 Algorithm-1 fold over every
    (lane, run, epoch, survivor) point and the trailing spans run after the
    loop over the stacked epochs.  Felled slots join the re-execution race,
    leave the resync point and the survivor energies, and pay the failed
    node's closed form; with no mask the same formulas reduce through exact
    neutral elements (max with -inf, a factor of 1).  The reference's
    ``_renewal_scan``, written independently of ``renewal_compose``."""
    dev = gaps.device
    f8 = lambda x: x.to(dtype=torch.float64)
    f4 = lambda x: x.to(dtype=torch.float32)
    n_lanes = inp.interval.shape[0]
    n_runs, n_epochs = gaps.shape[-2:]
    n = inp.period.shape[-1]
    n_nodes = n + 1
    lane = lambda x, k: x.reshape((n_lanes,) + (1,) * k)   # vs (P, ...k axes)
    interval, dur = f8(inp.interval), f8(inp.dur)
    beta, gamma = f8(inp.ladder.beta), f8(inp.ladder.gamma)        # (P, F)
    p_comp0 = f8(inp.ladder.p_comp[..., 0])
    p_ckpt0 = f8(inp.ladder.p_ckpt[..., 0])
    dur_fa = dur * gamma[:, 0]
    t_restart = f8(inp.t_restart)
    t_dr = f8(inp.t_down) + t_restart
    makespan = torch.as_tensor(makespan_s, dtype=torch.float64,
                               device=dev).expand(n_lanes)
    period = f8(inp.period)[:, None, :]                            # (P, 1, N)
    m_all = (torch.zeros((n_runs, n_epochs, n), dtype=torch.bool, device=dev)
             if felled is None else felled.to(device=dev, dtype=torch.bool))
    neg_inf = -float("inf")

    # the carry, (P, R, ...)
    ages_all = torch.cat([f8(inp.age0), f8(inp.reexec0)[:, None]], dim=-1)[
        :, None, :].expand(n_lanes, n_runs, n_nodes)
    exec_anchor = f8(inp.exec_rem0)[:, None, :].expand(n_lanes, n_runs, n)
    bal_elapsed = torch.zeros((n_lanes, n_runs), dtype=torch.float64, device=dev)
    t_anchor = torch.zeros_like(bal_elapsed)
    alive = torch.ones((n_lanes, n_runs), dtype=torch.bool, device=dev)
    ys = []
    for k in range(n_epochs):
        delta, m = gaps[..., k], m_all[:, k]            # ([P,] R), (R, N)
        occurs = alive & (bal_elapsed + delta <= lane(makespan, 1))
        age_all, work, _, d_eff_all = planning.advance_checkpoint_sawtooth(
            ages_all, delta[..., None], lane(interval, 2), lane(dur, 2))
        rem = torch.remainder(exec_anchor - work[..., :-1], period)
        exec_rem = torch.where(rem == 0.0, period, rem)
        d_eff_fail = d_eff_all[..., -1]
        # felled survivors' lost work joins the re-execution race; the
        # resync point is the furthest non-felled survivor
        reexec = torch.maximum(age_all[..., -1], torch.amax(
            torch.where(m, age_all[..., :-1], neg_inf), dim=-1))
        p_star = torch.clamp_min(
            torch.amax(torch.where(m, neg_inf, exec_rem), dim=-1), 0.0)
        t_e = lane(t_dr, 1) + reexec + p_star                      # epoch span T_E
        ys.append((occurs, age_all, work, exec_rem, d_eff_all,
                   None if stats else torch.where(
                       occurs, t_anchor + d_eff_fail, 0.0)))
        # re-anchor: coordinated resync checkpoint -> ages 0, progress P*
        ages_all = torch.where(occurs[..., None], 0.0, ages_all)
        exec_anchor = torch.where(
            occurs[..., None],
            post_recovery_anchor(exec_rem, period, p_star=p_star), exec_anchor)
        t_anchor = torch.where(
            occurs, t_anchor + d_eff_fail + t_e + lane(dur_fa, 1), t_anchor)
        bal_elapsed = torch.where(occurs, bal_elapsed + d_eff_fail, bal_elapsed)
        alive = alive & occurs

    stack = lambda i: torch.stack([y[i] for y in ys], dim=2)
    valid, age_all, work_all, exec_rem_k, d_eff_all = (stack(i) for i in range(5))

    # --- per-epoch accounting over the stacked epochs, (P, R, K[, N]) ------
    m4 = m_all[None]
    age_f = age_all[..., :-1]
    reexec_f = torch.maximum(age_all[..., -1], torch.amax(
        torch.where(m4, age_f, neg_inf), dim=-1))
    t_recover = lane(t_dr, 2) + reexec_f
    t_failed_k = t_recover[..., None] + exec_rem_k
    p_star = torch.clamp_min(
        torch.amax(torch.where(m4, neg_inf, exec_rem_k), dim=-1), 0.0)
    t_e = t_recover + p_star

    # balanced span energy up to each node's snapped failure instant (the
    # sawtooth's work / checkpoint split at the snapped instant), plus the
    # coordinated resync checkpoint closing each epoch
    e_bal = _tree_sum(work_all * lane(p_comp0, 3)
                      + (d_eff_all - work_all) * lane(p_ckpt0, 3))
    balanced = _tree_sum(torch.where(
        valid, e_bal + lane(n_nodes * dur_fa * p_ckpt0, 2), 0.0))
    # failed node over [failure, T_E]: restart at P_ckpt + re-execution and
    # post-recovery serving at P_comp; each felled slot pays the same
    epoch_failed = torch.where(
        valid, (1.0 + m4.sum(dim=-1).to(torch.float64))
        * (lane(t_restart * p_ckpt0, 2) + (reexec_f + p_star) * lane(p_comp0, 2)),
        0.0)

    # the checkpoint plan as F node-batch columns: the fa column (and the
    # move-ahead) from checkpoint_plan, the others from the same closed form
    plan0 = planning.checkpoint_plan(
        exec_rem_k, age_f, t_failed_k, interval=lane(interval, 3),
        dur=lane(dur, 3), beta=lane(beta[:, 0], 4), gamma=None,
        move_ahead=lane(inp.move_ahead, 3),
        move_frac=lane(f8(inp.move_frac), 3))
    move = plan0.plan_move.to(torch.float64)
    n_cols = [plan0.n_ckpt[..., 0]] + [
        planning.timer_checkpoint_count(exec_rem_k, age_f, lane(beta[:, f], 3),
                                        lane(interval, 3)) + move
        for f in range(1, beta.shape[-1])]
    # Algorithm 1 in float32 on casts of the float64 geometry, ladder first
    ladder32 = em.LadderArrays(**{
        f: f4(getattr(inp.ladder, f)).T.reshape((-1, n_lanes, 1, 1, 1))
        for f in _LADDER})
    sleep32 = em.SleepArrays(**{f: lane(f4(getattr(inp.sleep, f)), 3)
                                for f in _SLEEP})
    decision = strategies.evaluate_strategies_fold(
        f4(exec_rem_k), f4(t_failed_k), n_cols, lane(f4(dur), 3), ladder32,
        sleep32, lane(inp.wait_mode, 3), lane(f4(inp.p_idle_wait), 3),
        mu1=lane(f4(inp.mu1), 3), mu2=lane(f4(inp.mu2), 3))

    # per-survivor epoch energy = window energy + trailing fa span to T_E
    ct_ref = exec_rem_k * lane(beta[:, 0], 3) \
        + n_cols[0] * lane(dur, 3) * lane(gamma[:, 0], 3)
    t_e2 = t_e[..., None]
    trail_ref = torch.clamp_min(
        t_e2 - torch.maximum(t_failed_k, ct_ref), 0.0) * lane(p_comp0, 3)
    trail_int = torch.clamp_min(
        t_e2 - torch.maximum(t_failed_k, f8(decision.comp_time)), 0.0) \
        * lane(p_comp0, 3)
    # felled slots are accounted through epoch_failed, not the windows
    v2 = valid[..., None] & ~m4
    epoch_ref = torch.where(v2, f8(decision.energy_reference) + trail_ref, 0.0)
    epoch_int = torch.where(v2, f8(decision.energy_intervened) + trail_int, 0.0)

    # balanced tail: the rest of the failure-free work (mid-checkpoint snaps
    # can nudge bal_elapsed past the makespan; clamp)
    span = torch.clamp_min(lane(makespan, 1) - bal_elapsed, 0.0)
    w_t, ck_t = planning.balanced_span(ages_all, span[..., None],
                                       lane(interval, 2), lane(dur, 2))
    balanced = balanced + _tree_sum(w_t * lane(p_comp0, 2)
                                    + ck_t * lane(p_ckpt0, 2))

    e_failed = _tree_sum(epoch_failed)
    energy_ref = balanced + _tree_sum(_tree_sum(epoch_ref)) + e_failed
    energy_int = balanced + _tree_sum(_tree_sum(epoch_int)) + e_failed
    common = dict(
        valid=valid,
        n_failures=valid.sum(dim=-1, dtype=torch.int32),
        truncated=alive & (bal_elapsed < lane(makespan, 1)),
        end_time=t_anchor + span,
        balanced_energy=balanced,
        energy_ref=energy_ref,
        energy_int=energy_int,
        saving=energy_ref - energy_int,
    )
    if stats:
        # integer action counts over valid (epoch, survivor) points: the
        # summary rates divide them by the point count on the host
        i32 = lambda mask: (v2 & mask).sum(dim=(2, 3), dtype=torch.int32)
        return dict(
            common,
            n_points=v2.sum(dim=(2, 3), dtype=torch.int32),
            n_sleep=i32(decision.wait_action == int(em.WaitAction.SLEEP)),
            n_min_freq=i32(decision.wait_action == int(em.WaitAction.MIN_FREQ)),
            n_comp_changed=i32(decision.comp_changed),
            n_infeasible=i32(~decision.feasible_any),
        )
    return dict(
        common,
        decision=decision,
        t_fail=stack(5),
        exec_rem=exec_rem_k,
        t_failed=t_failed_k,
        t_renewal=torch.where(valid, t_e, 0.0),
        epoch_ref=epoch_ref,
        epoch_int=epoch_int,
        epoch_failed=epoch_failed,
    )


def _attach_failed_counts(out: dict, failed: torch.Tensor, n_nodes: int,
                          fmask=None) -> dict:
    """Per-node failure counts over valid epochs, reduced over runs;
    ``out['valid']`` is (S|P, R, K) bool and ``failed`` (R, K), or (C, P,
    R, K) and (C, 1, R, K) on the cluster axis.  With a correlated
    sampler's physical-node ``fmask`` ((R, K, n_nodes)) every felled node
    counts, not just the primary."""
    valid = out.pop("valid")
    if fmask is None:
        node = torch.arange(n_nodes, device=valid.device)
        hit = valid[..., None] & (failed[..., None] == node)
    else:
        hit = valid[..., None] & fmask
    out["failed_counts"] = hit.to(torch.int32).sum(dim=(-3, -2))
    return out


def _sample_histories(process, topology, key, n_runs: int, max_failures: int,
                      n_nodes: int, device):
    """The histories every engine composes: ``(gaps float32 (R, K), failed
    (R, K), felled (R, K, N) survivor-slot mask or None, fmask (R, K,
    n_nodes) physical-node mask or None)`` on ``device``.  The independent
    sampler without a topology, the correlated shock sampler with one."""
    if topology is None:
        gaps32, failed = failures.sample_renewal_gaps(
            process, key, n_runs, max_failures, n_nodes, device)
        return gaps32, failed, None, None
    gaps32, fmask, failed = node_topology.sample_correlated_renewal_gaps(
        topology, process, key, n_runs, max_failures, n_nodes, device)
    return (gaps32, failed, node_topology.survivor_slot_mask(fmask, failed),
            fmask)


def _renewal_mc_core(stacked: SweepInputs, key, makespan_s, process,
                     n_runs: int, max_failures: int, stats: bool,
                     topology=None):
    """Sampling (shared across lanes — common random numbers, the kernel
    engine's histories) plus the float64 scan; returns ``(out, gaps,
    failed)``."""
    dev = stacked.interval.device
    n_nodes = stacked.period.shape[-1] + 1
    gaps32, failed, felled, fmask = _sample_histories(
        process, topology, key, n_runs, max_failures, n_nodes, dev)
    gaps = gaps32.to(torch.float64)
    out = _renewal_scan(stacked, gaps, makespan_s, stats=stats, felled=felled)
    if stats:
        out = _attach_failed_counts(out, failed, n_nodes, fmask=fmask)
    return out, gaps, failed


def _renewal_fleet_mc_core(stacked: SweepInputs, key, makespan_s, process,
                           n_runs: int, max_failures: int) -> dict:
    """The cluster axis: ``stacked`` carries leading ``(C, P)`` axes
    (clusters x policies, ``optimize.fleet_policy_inputs``),
    ``makespan_s`` is a ``(C, P)`` tensor on its device and ``process`` a
    same-family stack over the C clusters (``failures.stack_processes``).

    Each cluster lane samples its own histories at the shared ``key``
    through its own parameters (one batched sampler pass, ``(C, R, K)``)
    and one float64 scan runs over the ``C x P`` lanes, every policy of a
    cluster on that cluster's histories.  Samplers and scan are
    elementwise per lane with fixed-tree sums, so each cluster's rows are
    bit-identical to a standalone single-cluster call at the same key and
    do not depend on the clusters batched beside it.  Stats only: returns
    the ``RenewalDeviceStats`` fields as a dict, leading ``(C, P)``."""
    n_clusters, n_policies = stacked.interval.shape
    n_nodes = stacked.period.shape[-1] + 1
    gaps32, failed = failures.sample_fleet_renewal_gaps(
        process, key, n_runs, max_failures, n_nodes, stacked.interval.device)
    flat = lambda a: a.reshape((n_clusters * n_policies,) + a.shape[2:])
    lanes = _map_leaves(lambda xs: flat(xs[0]), [stacked])
    gaps = flat(gaps32.to(torch.float64)[:, None].expand(
        (n_clusters, n_policies) + tuple(gaps32.shape[1:])))
    out = _renewal_scan(lanes, gaps, flat(makespan_s), stats=True)
    out = {k: v.reshape((n_clusters, n_policies) + v.shape[1:])
           for k, v in out.items()}
    return _attach_failed_counts(out, failed[:, None], n_nodes)


def _wrap_device_result(out: dict, gaps: torch.Tensor,
                        failed_node) -> RenewalDeviceResult:
    valid = out["valid"]
    failed = (torch.zeros(gaps.shape, dtype=torch.int32, device=valid.device)
              if failed_node is None else
              torch.as_tensor(failed_node).to(device=valid.device,
                                               dtype=torch.int32))
    failed = torch.where(valid, failed.expand(valid.shape), -1)
    return RenewalDeviceResult(gaps=gaps, failed_node=failed, **out)


def _histories(gaps, felled, device):
    """Explicit histories as float64 ``(R, K)`` gaps and an ``(R, K, N)``
    felled mask (or None) on ``device``."""
    gaps = torch.atleast_2d(torch.as_tensor(np.asarray(_np(gaps), np.float64),
                                            device=device))
    if felled is not None:
        felled = torch.as_tensor(np.asarray(_np(felled), bool), device=device)
        felled = felled.expand(gaps.shape + felled.shape[-1:])
    return gaps, felled


def renewal_compose_device(cfgs, gaps, makespan_s: float, failed_node=None,
                           felled=None, device="cuda") -> RenewalDeviceResult:
    """Compose explicit failure histories with the float64 scan on
    ``device``: ``cfgs`` is one ``ScenarioConfig`` or a stack sharing
    survivor count and ladder size, ``gaps`` (R, K) or (K,) shared by every
    scenario, ``felled`` an (R, K, N) survivor-slot mask (see
    ``renewal_compose``).  Semantics match the host oracle to ~1e-9."""
    dev = resolve_device(device)
    _, stacked = _renewal_device_inputs(cfgs, torch.float64, dev)
    gaps, felled = _histories(gaps, felled, dev)
    out = _renewal_scan(stacked, gaps, float(makespan_s), felled=felled)
    return _wrap_device_result(out, gaps, failed_node)


def renewal_compose_policies(stacked: SweepInputs, gaps, makespan_s,
                             felled=None) -> RenewalDeviceResult:
    """Compose explicit histories for a policy-stacked float64
    ``SweepInputs`` (``optimize.policy_inputs``) with a (P,) per-policy wall
    makespan, on the device ``stacked`` lies on; histories and ``felled``
    are shared by every policy (common random numbers)."""
    dev = stacked.interval.device
    gaps, felled = _histories(gaps, felled, dev)
    out = _renewal_scan(stacked, gaps, torch.as_tensor(
        np.asarray(makespan_s, np.float64), device=dev), felled=felled)
    return _wrap_device_result(out, gaps, None)


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


def _renewal_kernel_mc(stacked: SweepInputs, key, makespan_s, process,
                       n_runs: int, max_failures: int,
                       compensated: bool = True,
                       topology=None) -> RenewalDeviceStats:
    """Sampling (shared across lanes — common random numbers) plus the
    packed float32 composition through ``kernels.renewal_scan``; felled
    slots travel in the kernel's (K, N, R) float32 layout."""
    from repro_torch.kernels import renewal_scan as rs

    dev = stacked.interval.device
    n_nodes = stacked.period.shape[-1] + 1
    gaps32, failed, felled, fmask = _sample_histories(
        process, topology, key, n_runs, max_failures, n_nodes, dev)
    params, nodes, ladder = _pack_kernel_inputs(stacked, makespan_s)
    felled_t = (None if felled is None else
                felled.permute(1, 2, 0).to(torch.float32).contiguous())
    out = rs.renewal_scan(params, nodes, ladder, gaps32.T.contiguous(),
                          felled_t, compensated=compensated)
    out["valid"] = out["valid"].transpose(1, 2).bool()
    out["truncated"] = out["truncated"].bool()
    out = _attach_failed_counts(out, failed, n_nodes, fmask=fmask)
    return RenewalDeviceStats(**out)


def _check_engine(engine: str, stats: bool) -> None:
    if engine not in ("scan", "kernel"):
        raise ValueError(f"unknown engine {engine!r} (use 'scan' or 'kernel')")
    if engine == "kernel" and not stats:
        raise ValueError("engine='kernel' is the stats-only hot path; the "
                         "per-epoch diagnostic view is the scan engine's")


def renewal_monte_carlo_device(cfgs, key, *, n_runs: int = 256,
                               makespan_s: float = 30 * 24 * 3600.0,
                               mtbf_s: float = 14 * 24 * 3600.0,
                               max_failures: int = 64, stats: bool = False,
                               process: Optional[failures.FailureProcess] = None,
                               topology=None, engine: str = "scan",
                               device="cuda"):
    """Whole-run Monte-Carlo for stacked scenarios with the sampling on
    ``device``.  ``engine="scan"`` composes with the float64 scan and
    returns the per-epoch ``RenewalDeviceResult`` (``stats=False``) or the
    lean ``RenewalDeviceStats`` (``stats=True``); ``engine="kernel"`` is
    the float32 Kahan-ledger kernel, one launch, stats only.  Both see the
    same histories for a key; a ``topology`` swaps in the correlated shock
    sampler on both."""
    _check_engine(engine, stats)
    dev = resolve_device(device)
    proc = failures.as_process(process, mtbf_s)
    if engine == "kernel":
        _, stacked = _renewal_device_inputs(cfgs, torch.float32, dev)
        return _renewal_kernel_mc(stacked, key, float(makespan_s), proc,
                                  n_runs, max_failures, topology=topology)
    _, stacked = _renewal_device_inputs(cfgs, torch.float64, dev)
    out, gaps, failed = _renewal_mc_core(stacked, key, float(makespan_s), proc,
                                         n_runs, max_failures, stats, topology)
    return RenewalDeviceStats(**out) if stats else \
        _wrap_device_result(out, gaps, failed)


def renewal_monte_carlo_policies(stacked: SweepInputs, key, *, makespan_s,
                                 n_runs: int = 256, max_failures: int = 32,
                                 mtbf_s: Optional[float] = None,
                                 process: Optional[failures.FailureProcess] = None,
                                 stats: bool = True, topology=None,
                                 engine: str = "scan"):
    """Whole-run Monte-Carlo over a policy-stacked float64 ``SweepInputs``
    (leading policy axis P, per-policy ``makespan_s``), on the device
    ``stacked`` lies on.  The sampler never sees the policy axis, so every
    lane meets the same histories (common random numbers) and each lane is
    bit-identical to a standalone ``renewal_monte_carlo_device`` call on
    that policy with the same engine.  Engines as there; a ``topology``
    swaps in the correlated shock sampler, whose histories and felled masks
    every lane shares too.

    **Cluster axis.**  A ``stacked`` with leading ``(C, P)`` axes
    (``optimize.fleet_policy_inputs``) evaluates C clusters x P policies in
    one scan (``_renewal_fleet_mc_core``): ``makespan_s`` is then ``(C,
    P)`` and ``process`` a same-family stack over the C clusters
    (``failures.stack_processes``); each cluster's rows are bit-identical
    to a standalone call on that cluster at the same key.  Scan engine,
    stats only, independent sampler: the kernel engine, ``stats=False`` and
    ``topology`` raise, as in the reference."""
    _check_engine(engine, stats)
    proc = failures.as_process(process, mtbf_s)
    if stacked.interval.dim() == 2:
        if engine != "scan":
            raise ValueError("the cluster axis runs on the scan engine only "
                             "(the kernel's grid is lanes x runs)")
        if not stats:
            raise ValueError(
                "cluster-stacked dispatch is the stats-only advisory hot "
                "path; use per-cluster calls for per-epoch diagnostics")
        if topology is not None:
            raise ValueError(
                "cluster-stacked dispatch samples iid per cluster; "
                "correlated topologies are a single-cluster feature")
        n_clusters = stacked.interval.shape[0]
        try:
            stacked_c = failures.fleet_size(proc)
        except ValueError:
            stacked_c = None
        if stacked_c != n_clusters:
            raise ValueError(
                f"cluster-stacked dispatch needs a process stacked over the "
                f"{n_clusters} cluster lanes (failures.stack_processes)")
        makespan = torch.as_tensor(np.asarray(makespan_s, np.float64),
                                   device=stacked.interval.device)
        if makespan.shape != stacked.interval.shape:
            raise ValueError(
                f"fleet makespan_s must be (C, P) = "
                f"{tuple(stacked.interval.shape)}, got {tuple(makespan.shape)}")
        return RenewalDeviceStats(**_renewal_fleet_mc_core(
            stacked, key, makespan, proc, n_runs, max_failures))
    if engine == "kernel":
        return _renewal_kernel_mc(stacked, key, makespan_s, proc, n_runs,
                                  max_failures, topology=topology)
    makespan = torch.as_tensor(np.asarray(makespan_s, np.float64),
                               device=stacked.interval.device)
    out, gaps, failed = _renewal_mc_core(stacked, key, makespan, proc, n_runs,
                                         max_failures, stats, topology)
    return RenewalDeviceStats(**out) if stats else \
        _wrap_device_result(out, gaps, failed)


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
                     mtbf_s: float, max_failures: int, felled=None,
                     fmask=None) -> RenewalMonteCarloSummary:
    """Reduce one scenario's (R, K[, N]) host-oracle arrays to expectations
    (rates as means over valid, non-felled decision points).  ``fmask``
    (physical-node mask) attributes every felled node in ``per_node``, as
    the device path's counts do."""
    valid = _np(valid).astype(bool)
    counts = valid.sum(axis=1)
    if fmask is None:
        failed_node = _np(failed_node)
        per_node = tuple(
            float(np.mean(np.sum((failed_node == m) & valid, axis=1)))
            for m in range(n_survivors + 1))
    else:
        fmask = _np(fmask).astype(bool)
        per_node = tuple(
            float(np.mean(np.sum(fmask[:, :, m] & valid, axis=1)))
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
                        max_failures: int = 64, engine: str = "device",
                        process: Optional[failures.FailureProcess] = None,
                        topology=None, device="cuda") -> RenewalMonteCarloSummary:
    """Monte-Carlo whole-run energy under per-node failure processes.

    ``engine="device"`` (the default) runs the float64 scan and
    ``engine="kernel"`` the float32 Kahan-ledger kernel, both through
    ``renewal_monte_carlo_device``; ``engine="host"`` the float64 oracle
    (``renewal_compose``) on the same histories, reduced by the same
    summary code.  With a ``process`` the summary's ``mtbf_s`` reports the
    process's mean gap.  A ``topology`` swaps in the correlated shock
    sampler on every engine.
    """
    dev = resolve_device(device)
    if process is not None:
        mtbf_s = float(np.mean(failures.as_process(process).mean_s()))
    kw = dict(n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
              max_failures=max_failures)
    if engine in ("device", "kernel"):
        res = renewal_monte_carlo_device(
            cfg, key, stats=True, process=process, topology=topology,
            device=dev, engine="kernel" if engine == "kernel" else "scan",
            **kw)
        return _summarize_device_scenario(_stats_to_host(res), 0, **kw)
    if engine != "host":
        raise ValueError(
            f"unknown engine {engine!r} (use 'device', 'kernel' or 'host')")
    n_nodes = len(cfg.survivors) + 1
    felled = fmask = None
    if topology is None:
        gaps, failed = renewal_failure_gaps(
            key, n_runs, n_nodes, max_failures, mtbf_s, process=process,
            device=dev)
    else:
        gaps, failed, fmask = renewal_failure_gaps(
            key, n_runs, n_nodes, max_failures, mtbf_s, process=process,
            topology=topology, device=dev)
        felled = node_topology.survivor_slot_mask(fmask, failed)
    res = renewal_compose(cfg, gaps, makespan_s, failed_node=failed,
                          felled=felled, device=dev)
    return _renewal_summary(
        felled=felled, fmask=fmask,
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
                                  topology=None, engine: str = "scan",
                                  device="cuda") -> dict:
    """name -> ``RenewalMonteCarloSummary`` for stacked scenarios from one
    ``renewal_monte_carlo_device`` call (``engine="scan"`` or
    ``"kernel"``); every scenario sees the same sampled histories."""
    cfg_list = list(cfgs)
    if process is not None:
        mtbf_s = float(np.mean(failures.as_process(process).mean_s()))
    kw = dict(n_runs=n_runs, makespan_s=makespan_s, mtbf_s=mtbf_s,
              max_failures=max_failures)
    res = _stats_to_host(renewal_monte_carlo_device(
        cfg_list, key, stats=True, process=process, topology=topology,
        engine=engine, device=device, **kw))
    return {cfg.name: _summarize_device_scenario(res, s, **kw)
            for s, cfg in enumerate(cfg_list)}
