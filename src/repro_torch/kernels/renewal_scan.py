"""The fused renewal epoch-scan + Algorithm-1 fold, as a CUDA kernel.

Replaces ``repro.kernels.renewal_scan.renewal_scan_pallas`` (the Pallas TPU
kernel ``_renewal_kernel``).  For every policy/scenario lane and
Monte-Carlo run it composes the whole K-epoch renewal recursion in float32:
checkpoint-sawtooth advance, rendezvous wrap, re-execution race, resync
point, re-anchor, the balanced-span energy, the checkpoint plan, the
Algorithm-1 fold and the trailing span, with a Kahan-compensated energy
ledger.  Operands and outputs are the reference's:

  params (P, N_PARAMS) f32 — ``pack_lane_params``;
  nodes  (P, 3, N) f32     — rows ``[age0, exec_rem0, period]``;
  ladder (P, 5, F) f32     — rows ``[freq_ghz, p_comp, beta, p_ckpt, gamma]``;
  gaps   (K, R) f32        — balanced-execution gaps, runs last;
  felled (K, N, R) f32 0/1 or None — survivor-slot shock mask;
  -> ``valid`` (P, K, R) int32 plus the twelve (P, R) ``STAT_FIELDS``.

Two implementations of one function live here:

  * ``renewal_scan_reference`` — the plain PyTorch version: a Python loop
    over K on (P, N, R) tensors that reuses the port's ``planning``,
    ``strategies.evaluate_strategies_fold`` and
    ``scenarios.post_recovery_anchor``.  Sums over survivors are written
    out in node order so every float32 operation matches the kernel.
  * the CUDA kernels in ``csrc/renewal_scan.cu``.  A group of G lanes of
    one warp takes each (lane, run), its survivors strided over the group
    (survivor i in lane i % G) with every survivor's carry in registers,
    the cross-node sums and maxima gathered by warp shuffles in node order:
    one lane per survivor up to ``FAST_MAX_N`` survivors, ``GROUP_LANES``
    lanes up to ``GROUP_N``.  One lane per run is the other mapping: with
    the survivors in registers up to ``THROUGHPUT_MAX_N``, and past it
    ``RUN_KERNEL``, which loops over the survivors with their anchors in
    shared memory (the only mapping past ``GROUP_N``).  While a launch's
    runs are few (latency-bound, as the main path) the group is taken; once
    the runs fill the card (throughput-bound, as the policy grid) one lane
    per run (``lane_choices``).  The ladder unrolls to ``FAST_MAX_F``
    levels, or to ``MAX_F`` for deeper ladders.  The float64 wraps take an
    exact fast floor-mod; gaps are loaded one epoch ahead; a warp leaves the
    epoch loop once all its runs are dead, and ``valid`` is written once
    per block after the scan (design notes and the arguments for
    bit-equality in the source).  Every mapping gives the plain version's
    bits.

One deliberate difference from the TPU kernel: the rendezvous anchors and
their wrap are float64 (the rest is float32).  In float32 the rounding of
``anchor - work mod period`` is carried across re-anchors, and where the
exact remainder is 0 (snapped failures on a checkpoint interval
commensurate with the rendezvous period) a survivor lands a whole period
away from the float64 oracle (ROADMAP.md, Queue 3).

``renewal_scan`` dispatches on where the tensors lie: CPU tensors take the
plain version, CUDA tensors launch the kernel (and count the launch in
``LAUNCHES``).  Anything else raises (``_build.dispatch``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import spans
from repro_torch._device import resolve_device
from repro_torch.core import energy_model as em
from repro_torch.core import planning
from repro_torch.core import strategies
from repro_torch.core.scenarios import post_recovery_anchor
from repro_torch.kernels import _build

__all__ = ["renewal_scan", "renewal_scan_reference", "pack_lane_params",
           "N_PARAMS", "PARAM_COLS", "STAT_FIELDS", "LAUNCHES",
           "MAX_N", "MAX_F", "FAST_MAX_N",
           "FAST_MAX_F", "GROUP_N", "GROUP_LANES", "THROUGHPUT_MAX_N",
           "RUN_KERNEL", "lane_choices", "kernel_name"]

# column map of the packed per-lane scalar row
PARAM_COLS = (
    "interval", "dur", "reexec0", "t_down", "t_restart", "mu1", "mu2",
    "wait_mode", "p_idle_wait", "move_ahead", "move_frac", "makespan",
    "t_go_sleep", "t_wakeup", "p_go_sleep", "p_wakeup", "p_sleep",
)
N_PARAMS = len(PARAM_COLS)

# kernel outputs after the (P, K, R) valid mask, in order
STAT_FIELDS = (
    ("energy_ref", torch.float32), ("energy_int", torch.float32),
    ("saving", torch.float32), ("balanced_energy", torch.float32),
    ("end_time", torch.float32),
    ("n_failures", torch.int32), ("truncated", torch.int32),
    ("n_points", torch.int32), ("n_sleep", torch.int32),
    ("n_min_freq", torch.int32), ("n_comp_changed", torch.int32),
    ("n_infeasible", torch.int32),
)
_N_FSTATS = sum(dt == torch.float32 for _, dt in STAT_FIELDS)

# bounds of the CUDA kernels (csrc/renewal_scan.cu).  renewal_scan_kernel
# <N, G, F> keeps every survivor's carry in registers: it is instantiated
# per survivor count up to kMaxN (FAST_MAX_N), and for the counts past it up
# to kGroupN (GROUP_N) with the count at run time and GROUP_LANES lanes per
# run; its ladder unrolls to kMaxF (FAST_MAX_F) levels, or to kCapF (MAX_F)
# for deeper ladders (the Table-4 path has 3 survivors and 4 levels).
# RUN_KERNEL takes one lane per run past THROUGHPUT_MAX_N survivors (its
# survivors' anchors in shared memory), up to kCapN (MAX_N) survivors and
# kCapF levels.  Past MAX_N or MAX_F the wrapper raises.
FAST_MAX_N = 8
FAST_MAX_F = 4
MAX_N = 64
MAX_F = 16
GROUP_N = 16
GROUP_LANES = 8
# survivor counts whose one-lane-per-run mapping holds its survivors in
# registers (kThroughputMaxN)
THROUGHPUT_MAX_N = 4
RUN_KERNEL = "renewal_scan_run_kernel"

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = spans.counter("renewal_scan")

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("renewal_scan", "renewal_scan.cu", _build.EXACT_FLAGS)
# the C entry point's argument types, the stream's last
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4


def lane_choices(n: int) -> tuple:
    """Lanes per run of the mappings ``n`` survivors have, in increasing
    order: one lane per run (up to ``THROUGHPUT_MAX_N`` and past
    ``FAST_MAX_N``), and a group of lanes (one per survivor up to
    ``FAST_MAX_N``, ``GROUP_LANES`` up to ``GROUP_N``)."""
    group = n if n <= FAST_MAX_N else GROUP_LANES if n <= GROUP_N else 1
    one = n <= THROUGHPUT_MAX_N or n > FAST_MAX_N
    return tuple(sorted({group} | ({1} if one else set())))


def kernel_name(n: int, n_levels: int, lanes: int | None = None) -> str:
    """The CUDA kernel a shape launches with ``lanes`` lanes per run (the
    fewest of ``lane_choices`` by default): ``RUN_KERNEL`` for one lane
    past ``THROUGHPUT_MAX_N`` survivors, else ``renewal_scan_kernel<N,G,F>``
    with N the survivor count (past ``FAST_MAX_N``, ``GROUP_N``) and F the
    ladder's unrolled depth."""
    lanes = min(lane_choices(n)) if lanes is None else lanes
    if lanes == 1 and n > THROUGHPUT_MAX_N:
        return RUN_KERNEL
    depth = FAST_MAX_F if n_levels <= FAST_MAX_F else MAX_F
    cap = GROUP_N if n > FAST_MAX_N else n
    return f"renewal_scan_kernel<{cap},{lanes},{depth}>"


def pack_lane_params(*, interval, dur, reexec0, t_down, t_restart, mu1, mu2,
                     wait_mode, p_idle_wait, move_ahead, move_frac, makespan,
                     sleep: em.SleepArrays, device="cuda") -> torch.Tensor:
    """Pack per-lane scalars (numpy arrays, tensors or python scalars) into
    the kernel's ``(P, N_PARAMS)`` float32 row, broadcasting scalars across
    lanes.  ``wait_mode`` and ``move_ahead`` travel as exact float32 values.
    Column order is ``PARAM_COLS``."""
    dev = resolve_device(device)
    cols = dict(
        interval=interval, dur=dur, reexec0=reexec0, t_down=t_down,
        t_restart=t_restart, mu1=mu1, mu2=mu2, wait_mode=wait_mode,
        p_idle_wait=p_idle_wait, move_ahead=move_ahead, move_frac=move_frac,
        makespan=makespan, t_go_sleep=sleep.t_go_sleep,
        t_wakeup=sleep.t_wakeup, p_go_sleep=sleep.p_go_sleep,
        p_wakeup=sleep.p_wakeup, p_sleep=sleep.p_sleep,
    )

    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    cols = {k: f32(v) for k, v in cols.items()}
    lanes = torch.broadcast_shapes(*(v.shape for v in cols.values())) or (1,)
    return torch.stack([cols[name].expand(lanes) for name in PARAM_COLS],
                       dim=1).contiguous()


def _kadd(s, c, x, compensated: bool):
    """One compensated-summation step: add ``x`` into the Kahan pair
    ``(s, c)``; ``compensated=False`` is the naive ``s + x``."""
    if not compensated:
        return s + x, c
    y = x - c
    t = s + y
    return t, (t - s) - y


def _node_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis (dim 1) in node order — the kernel's order."""
    s = x[:, 0]
    for i in range(1, x.shape[1]):
        s = s + x[:, i]
    return s


def _check_operands(params, nodes, ladder, gaps, felled):
    if params.dim() != 2 or params.shape[1] != N_PARAMS:
        raise ValueError(f"params must be (P, {N_PARAMS}); got {tuple(params.shape)}")
    n_lanes = params.shape[0]
    if nodes.dim() != 3 or nodes.shape[:2] != (n_lanes, 3):
        raise ValueError(f"nodes must be (P, 3, N); got {tuple(nodes.shape)}")
    if ladder.dim() != 3 or ladder.shape[:2] != (n_lanes, 5):
        raise ValueError(f"ladder must be (P, 5, F); got {tuple(ladder.shape)}")
    if gaps.dim() != 2:
        raise ValueError(f"gaps must be (K, R); got {tuple(gaps.shape)}")
    n_epochs, n_runs = gaps.shape
    if felled is not None and tuple(felled.shape) != (n_epochs, nodes.shape[2], n_runs):
        raise ValueError(f"felled must be (K, N, R) = "
                         f"{(n_epochs, nodes.shape[2], n_runs)}; "
                         f"got {tuple(felled.shape)}")


def renewal_scan_reference(params, nodes, ladder, gaps, felled=None, *,
                           compensated: bool = True) -> dict:
    """Plain PyTorch version of the renewal kernel (same operands/outputs).

    Eager float32 over (P, N, R) tensors on whatever device the operands
    lie on; a Python loop over the K epochs carries the state.  Every update
    and ledger increment is gated on ``occurs``, so infinite padded gaps
    never reach the carry; the Kahan pairs take their (zero) increment every
    epoch, exactly like the kernel.
    """
    f32 = torch.float32
    params, nodes, ladder, gaps = (torch.as_tensor(a).to(f32) for a in
                                   (params, nodes, ladder, gaps))
    _check_operands(params, nodes, ladder, gaps, felled)
    dev = params.device
    n_lanes = params.shape[0]
    n = nodes.shape[2]
    n_levels = ladder.shape[2]
    n_epochs, n_runs = gaps.shape
    if felled is None:
        m_all = torch.zeros((n_epochs, n, n_runs), dtype=torch.bool, device=dev)
    else:
        m_all = torch.as_tensor(felled).to(f32) > 0.5

    col = {name: params[:, i] for i, name in enumerate(PARAM_COLS)}
    c2 = {k: v[:, None] for k, v in col.items()}             # (P, 1)
    c3 = {k: v[:, None, None] for k, v in col.items()}       # (P, 1, 1)
    interval, dur = c3["interval"], c3["dur"]
    t_dr = c2["t_down"] + c2["t_restart"]
    makespan = c2["makespan"]
    wait_mode = c3["wait_mode"].to(torch.int32)
    move_ahead = c3["move_ahead"] > 0.5
    sleep = em.SleepArrays(
        t_go_sleep=c3["t_go_sleep"], t_wakeup=c3["t_wakeup"],
        p_go_sleep=c3["p_go_sleep"], p_wakeup=c3["p_wakeup"],
        p_sleep=c3["p_sleep"])
    lad = ladder.permute(1, 2, 0)[..., None, None]           # (5, F, P, 1, 1)
    lad_l = em.LadderArrays(freq_ghz=lad[0], p_comp=lad[1], beta=lad[2],
                            p_ckpt=lad[3], gamma=lad[4])
    beta0, gamma0 = lad_l.beta[0], lad_l.gamma[0]            # (P, 1, 1)
    p_comp0, p_ckpt0 = lad_l.p_comp[0], lad_l.p_ckpt[0]
    dur_fa = dur * gamma0
    p_comp0_2, p_ckpt0_2, dur_fa_2 = p_comp0[:, 0], p_ckpt0[:, 0], dur_fa[:, 0]

    age0, exec0, period = (nodes[:, i, :, None] for i in range(3))  # (P, N, 1)
    shape3 = (n_lanes, n, n_runs)
    ages_all = torch.cat([age0, c3["reexec0"]], dim=1).expand(
        n_lanes, n + 1, n_runs).clone()
    # rendezvous anchors and their wrap are float64 (see module doc)
    period64 = period.double()
    exec_anchor = exec0.double().expand(shape3).clone()
    neg_inf64 = torch.tensor(-torch.inf, dtype=torch.float64, device=dev)
    zero = torch.zeros((n_lanes, n_runs), dtype=f32, device=dev)
    izero = torch.zeros((n_lanes, n_runs), dtype=torch.int32, device=dev)
    bal, bal_c, t_anchor, t_anchor_c = zero, zero, zero, zero
    a_bal, a_bal_c, a_ref, a_ref_c = zero, zero, zero, zero
    a_int, a_int_c, a_sav, a_sav_c = zero, zero, zero, zero
    nfail, npts, nsleep, nminf, ncomp, ninf = (izero,) * 6
    alive = torch.ones((n_lanes, n_runs), dtype=torch.bool, device=dev)
    valid = torch.zeros((n_lanes, n_epochs, n_runs), dtype=torch.int32,
                        device=dev)
    cnt = lambda mask: _node_sum(mask.to(torch.int32))
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=dev)

    for k in range(n_epochs):
        delta = gaps[k][None, :]                             # (1, R)
        m = m_all[k][None]                                   # (1, N, R)
        occurs = alive & (bal + delta <= makespan)

        # geometry: the closed forms of the host oracle, in float32
        age_all, work_all, _, d_eff_all = planning.advance_checkpoint_sawtooth(
            ages_all, delta[:, None, :], interval, dur)      # (P, N+1, R)
        rem = torch.remainder(exec_anchor - work_all[:, :-1].double(), period64)
        exec_rem64 = torch.where(rem == 0.0, period64, rem)
        exec_rem = exec_rem64.to(f32)
        d_eff_fail = d_eff_all[:, -1]
        age_f = age_all[:, :-1]
        reexec = torch.maximum(
            age_all[:, -1], torch.amax(torch.where(m, age_f, neg_inf), dim=1))
        p_star64 = torch.clamp_min(
            torch.amax(torch.where(m, neg_inf64, exec_rem64), dim=1), 0.0)
        p_star = p_star64.to(f32)
        t_recover = t_dr + reexec
        t_failed = t_recover[:, None, :] + exec_rem          # (P, N, R)
        t_e = t_recover + p_star

        # balanced-span energy of the epoch + coordinated resync checkpoint
        e_bal = _node_sum(work_all * p_comp0 + (d_eff_all - work_all) * p_ckpt0)
        a_bal, a_bal_c = _kadd(a_bal, a_bal_c, torch.where(
            occurs, e_bal + (n + 1) * dur_fa_2 * p_ckpt0_2, 0.0), compensated)

        epoch_failed = torch.where(
            occurs,
            (1.0 + cnt(m.expand(shape3)).to(f32))
            * (c2["t_restart"] * p_ckpt0_2 + (reexec + p_star) * p_comp0_2),
            0.0)

        # checkpoint plan + Algorithm 1 (the fold the kernel inlines)
        plan0 = planning.checkpoint_plan(
            exec_rem, age_f, t_failed, interval=interval, dur=dur,
            beta=beta0[..., None], gamma=gamma0[..., None],
            move_ahead=move_ahead, move_frac=c3["move_frac"])
        move = torch.where(plan0.plan_move, 1.0, 0.0).to(f32)
        n_cols = [plan0.n_ckpt[..., 0]] + [
            planning.timer_checkpoint_count(
                exec_rem, age_f, lad_l.beta[f], interval) + move
            for f in range(1, n_levels)
        ]
        decision = strategies.evaluate_strategies_fold(
            exec_rem, t_failed, n_cols, dur, lad_l, sleep, wait_mode,
            c3["p_idle_wait"], mu1=c3["mu1"], mu2=c3["mu2"])

        ct_ref = exec_rem * beta0 + n_cols[0] * dur * gamma0
        t_e3 = t_e[:, None, :]
        trail_ref = torch.clamp_min(
            t_e3 - torch.maximum(t_failed, ct_ref), 0.0) * p_comp0
        trail_int = torch.clamp_min(
            t_e3 - torch.maximum(t_failed, decision.comp_time), 0.0) * p_comp0
        v2 = occurs[:, None, :] & ~m
        eni = decision.energy_reference + trail_ref
        ei = decision.energy_intervened + trail_int
        a_ref, a_ref_c = _kadd(
            a_ref, a_ref_c, _node_sum(torch.where(v2, eni, 0.0)) + epoch_failed,
            compensated)
        a_int, a_int_c = _kadd(
            a_int, a_int_c, _node_sum(torch.where(v2, ei, 0.0)) + epoch_failed,
            compensated)
        # saving from per-epoch differences — never the difference of totals
        a_sav, a_sav_c = _kadd(
            a_sav, a_sav_c, _node_sum(torch.where(v2, eni - ei, 0.0)),
            compensated)

        nfail = nfail + occurs.to(torch.int32)
        npts = npts + cnt(v2)
        nsleep = nsleep + cnt(
            v2 & (decision.wait_action == int(em.WaitAction.SLEEP)))
        nminf = nminf + cnt(
            v2 & (decision.wait_action == int(em.WaitAction.MIN_FREQ)))
        ncomp = ncomp + cnt(v2 & decision.comp_changed)
        ninf = ninf + cnt(v2 & ~decision.feasible_any)
        valid[:, k] = occurs.to(torch.int32)

        # re-anchor: coordinated resync checkpoint -> ages 0, progress P*
        # (post_recovery_anchor takes survivors on the trailing axis)
        anchor_next = post_recovery_anchor(
            exec_rem64.transpose(1, 2), period64.transpose(1, 2),
            p_star=p_star64).transpose(1, 2)
        # the clocks stay compensated in BOTH modes
        bal, bal_c = _kadd(bal, bal_c, torch.where(occurs, d_eff_fail, 0.0),
                           True)
        t_anchor, t_anchor_c = _kadd(
            t_anchor, t_anchor_c,
            torch.where(occurs, d_eff_fail + t_e + dur_fa_2, 0.0), True)
        ages_all = torch.where(occurs[:, None, :], 0.0, ages_all)
        exec_anchor = torch.where(occurs[:, None, :], anchor_next, exec_anchor)
        alive = alive & occurs

    # balanced tail over the remaining failure-free span
    span = torch.clamp_min(makespan - bal, 0.0)
    w_t, ck_t = planning.balanced_span(ages_all, span[:, None, :], interval, dur)
    a_bal, _ = _kadd(a_bal, a_bal_c,
                     _node_sum(w_t * p_comp0 + ck_t * p_ckpt0), compensated)

    outs = dict(
        energy_ref=a_bal + a_ref,
        energy_int=a_bal + a_int,
        saving=a_sav,
        balanced_energy=a_bal,
        end_time=t_anchor + span,
        n_failures=nfail,
        truncated=(alive & (bal < makespan)).to(torch.int32),
        n_points=npts,
        n_sleep=nsleep,
        n_min_freq=nminf,
        n_comp_changed=ncomp,
        n_infeasible=ninf,
    )
    return {"valid": valid, **outs}


def _launch_cuda(params, nodes, ladder, gaps, felled, compensated: bool,
                 lib=None, lanes=None) -> dict:
    """Launch the CUDA kernel on the operands' card (no synchronisation).
    ``lib`` is this package's build of ``csrc/renewal_scan.cu`` unless a
    caller passes another build of the same C interface to compare.  The
    shape picks the kernels; where it has two mappings (``lane_choices``:
    one lane per run, or a group) the kernel picks its lanes per run from
    the launch size, and ``lanes`` forces one, to compare them."""
    tensors = [params, nodes, ladder, gaps] + ([] if felled is None else [felled])
    _build.refuse("renewal_scan", *tensors)
    dev = params.device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"renewal_scan takes float32 operands; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("renewal_scan takes contiguous operands")
    _check_operands(params, nodes, ladder, gaps, felled)
    n_lanes = params.shape[0]
    n, n_levels = nodes.shape[2], ladder.shape[2]
    n_epochs, n_runs = gaps.shape
    if not 1 <= n <= MAX_N or not 1 <= n_levels <= MAX_F:
        raise ValueError(
            f"the CUDA renewal kernels support 1..{MAX_N} survivors and "
            f"1..{MAX_F} ladder levels (MAX_N, MAX_F); got N={n}, "
            f"F={n_levels}")
    if n_lanes < 1 or n_runs < 1 or n_epochs < 1:
        raise ValueError("renewal_scan needs P, K, R >= 1")
    if n_lanes > 65535:
        raise ValueError("renewal_scan supports at most 65535 lanes per launch")

    if lanes is not None and lanes not in lane_choices(n):
        raise ValueError(f"lanes per run at N={n} must be one of "
                         f"{lane_choices(n)}; got {lanes}")
    if lib is None:
        lib = _build.load_library(*LIBRARY)
    valid = torch.empty((n_lanes, n_epochs, n_runs), dtype=torch.int32,
                        device=dev)
    fstats = torch.empty((_N_FSTATS, n_lanes, n_runs), dtype=torch.float32,
                         device=dev)
    istats = torch.empty((len(STAT_FIELDS) - _N_FSTATS, n_lanes, n_runs),
                         dtype=torch.int32, device=dev)
    entry, argtypes, after = (
        ("renewal_scan_launch", _ARGTYPES, ()) if lanes is None
        else ("renewal_scan_launch_lanes", _ARGTYPES + [ctypes.c_int], (lanes,)))
    _build.launch(lib, "renewal_scan", entry, argtypes, dev,
                  params.data_ptr(), nodes.data_ptr(), ladder.data_ptr(),
                  gaps.data_ptr(), 0 if felled is None else felled.data_ptr(),
                  n_lanes, n, n_levels, n_epochs, n_runs, int(bool(compensated)),
                  valid.data_ptr(), fstats.data_ptr(), istats.data_ptr(),
                  after=after)
    out = {"valid": valid}
    fi = ii = 0
    for name, dt in STAT_FIELDS:
        if dt == torch.float32:
            out[name] = fstats[fi]
            fi += 1
        else:
            out[name] = istats[ii]
            ii += 1
    return out


def renewal_scan(params, nodes, ladder, gaps, felled=None, *,
                 compensated: bool = True) -> dict:
    """Fused renewal composition for ``P`` lanes over ``R`` runs of ``K``
    epochs (operands and outputs as the module doc).

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (counted in ``LAUNCHES``) and return without synchronising.
    ``compensated=False`` is the naive-summation ledger (the clocks stay
    compensated).  Mixed or other devices raise.
    """
    return _build.dispatch(
        "renewal_scan",
        [params, nodes, ladder, gaps] + ([] if felled is None else [felled]),
        lambda: renewal_scan_reference(params, nodes, ladder, gaps, felled,
                                       compensated=compensated),
        lambda: _launch_cuda(params, nodes, ladder, gaps, felled, compensated))
