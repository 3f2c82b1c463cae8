"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's main
path (the renewal Monte-Carlo over the paper's six Table-4 scenarios, the
42-policy grid and Weibull failures) at the size users run it, holds every
launch those paths make against the plain version on the same operands,
checks the results against the port's float64 host oracle, and times the
kernel alone and the entry points whole.  Every phase prints
one line; any failure exits non-zero.  The last three lines are the kernel
record (JSON), the list of kernels, and ``{"ok": true, "device": ...}``.
Exits non-zero without a result when no CUDA device is present, or when the
rest of the repository is missing.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM3 bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# analytic cost of one occurring (epoch, survivor) decision of the renewal
# kernel (benchmarks/failure_sweep.py, roofline methodology)
FLOP_PER_DECISION = 190.0

FULL_RUNS = 4096
FULL_EPOCHS = 64
MAKESPAN_S = 30 * 24 * 3600.0
MTBF_S = 14 * 24 * 3600.0
GRID_WORK_S = 2 * 24 * 3600.0
GRID_MTBF_S = 8 * 3600.0
ORACLE_RUNS = 256
WEIBULL_RUNS = 1024
KERNEL_REPS = 20          # launches queued back to back per kernel timing
TOL_ORACLE = 1e-4          # whole-run energies vs the float64 oracle
TOL_PLAIN = 1e-6           # kernel vs its plain version (bit-equal expected)
FLOAT_STATS = ("energy_ref", "energy_int", "saving", "balanced_energy",
               "end_time")


class Failed(RuntimeError):
    pass


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise Failed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> list:
    """Per-call milliseconds of ``fn`` (CUDA events, synchronised each
    call): the stream is idle at the start event, so the host's time up to
    the first launch counts too — what a caller of ``fn`` waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def kernel_only_ms(launch, n: int) -> tuple:
    """Median device milliseconds of one kernel launch, the wrapper's host
    time excluded, and the wrapper's host milliseconds per call.  A spin
    kernel holds the stream while the host queues ``n`` launches, each
    between two CUDA events; they then run back to back.  Fails if the host
    had not queued them all before the hold ended."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    hold = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    hold[0].record()
    torch.cuda._sleep(1_000_000)
    hold[1].record()
    torch.cuda.synchronize()
    ms_per_cycle = hold[0].elapsed_time(hold[1]) / 1e6
    hold_ms = max(20.0, 4 * n * host_ms)
    hold[0].record()
    torch.cuda._sleep(int(hold_ms / ms_per_cycle))
    hold[1].record()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(n):
        launch()
        ev[i + 1].record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    held_ms = hold[0].elapsed_time(hold[1])
    if queued_ms >= held_ms:
        raise Failed(f"kernel timing: the host took {queued_ms:.3f} ms to "
                     f"queue {n} launches, longer than the {held_ms:.3f} ms "
                     f"hold")
    return statistics.median(
        ev[i].elapsed_time(ev[i + 1]) for i in range(n)), host_ms


class Recorder:
    """Stands in for ``renewal_scan`` while an entry point runs: forwards
    every call and keeps its operands and outputs, so each launch of the
    path is held against the plain version on the inputs the path gave it."""

    def __init__(self, rs):
        self.rs, self.fn, self.calls = rs, rs.renewal_scan, []

    def __enter__(self):
        self.rs.renewal_scan = self
        return self

    def __exit__(self, *exc):
        self.rs.renewal_scan = self.fn

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, dict(out)))
        return out


def drive(rs, fn) -> tuple:
    """Run one entry point with the launch counts set to 0 just before it;
    returns (its result, the kernel launches it made, the recorded calls).
    Fails if it launched the kernel no time, or other than once per call."""
    rs.reset_launch_counts()
    with Recorder(rs) as rec:
        result = fn()
    torch.cuda.synchronize()
    launches = rs.LAUNCHES["renewal_scan"]
    if launches < 1:
        raise Failed("the path did not launch the renewal_scan kernel")
    if launches != len(rec.calls):
        raise Failed(f"{launches} launches for {len(rec.calls)} kernel calls")
    return result, launches, rec.calls


def check_summary(name: str, sm, out: dict, s: int) -> None:
    """The printed summary is the reduction of the checked kernel stats."""
    for got, want in (
            (sm.mean_failures, out["n_failures"][s].double().mean()),
            (sm.mean_energy_ref_j, out["energy_ref"][s].double().mean()),
            (sm.mean_energy_int_j, out["energy_int"][s].double().mean()),
            (sm.mean_saving_j, out["saving"][s].double().mean())):
        if abs(got - float(want)) > 1e-9 * abs(float(want)):
            raise Failed(f"{name}: summary {got!r} is not the mean of the "
                         f"kernel's stats ({float(want)!r})")


def compare_outputs(got: dict, want: dict) -> tuple:
    """Exact integer stats and valid mask; float stats within TOL_PLAIN
    relative.  Returns (max_abs_err, max_rel_err) over the float stats."""
    max_abs = max_rel = 0.0
    for name, w in want.items():
        g = got[name]
        if name in FLOAT_STATS:
            d = (g.double() - w.double()).abs()
            rel = d / w.double().abs().clamp_min(1e-30)
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float(rel.max()))
            if not torch.isfinite(g).all():
                raise Failed(f"kernel {name} has non-finite values")
        elif not torch.equal(g, w):
            n_bad = int((g != w).sum())
            raise Failed(f"kernel {name} differs from the plain version "
                         f"at {n_bad} entries")
    if max_rel > TOL_PLAIN:
        raise Failed(f"kernel floats differ from the plain version: "
                     f"max rel {max_rel:.3e} > {TOL_PLAIN}")
    return max_abs, max_rel


def check_against_oracle(phase, sweep, cfg, stats_row: dict, gaps, failed,
                         makespan_s, per_run: bool = True) -> tuple:
    """The first ORACLE_RUNS runs against the float64 host oracle on the same
    histories: failure counts exact per run; energies within TOL_ORACLE
    relative per run (``per_run``) or on their mean over the runs (the
    policy grid's output, the expected energy per policy); the saving within
    TOL_ORACLE of the reference energy.  Returns (gated error, worst
    per-run relative error, runs above TOL_ORACLE)."""
    host = sweep.renewal_compose(cfg, gaps, makespan_s, failed_node=failed,
                                 device="cpu")
    n_fail = stats_row["n_failures"][:ORACLE_RUNS].cpu().long()
    if not torch.equal(n_fail, host.n_failures):
        raise Failed(f"{phase} {cfg.name}: failure counts differ from the oracle")
    gated = worst_run = 0.0
    n_over = 0
    for field in ("energy_ref", "energy_int", "balanced_energy", "end_time"):
        if field not in stats_row:
            continue
        k = stats_row[field][:ORACLE_RUNS].double().cpu()
        h = getattr(host, field)
        rel = (k - h).abs() / h.abs()
        worst_run = max(worst_run, float(rel.max()))
        n_over = max(n_over, int((rel > TOL_ORACLE).sum()))
        err = float(rel.max()) if per_run else abs(float(k.mean() / h.mean()) - 1)
        gated = max(gated, err)
        if err > TOL_ORACLE:
            raise Failed(f"{phase} {cfg.name} {field}: rel {err:.3e} > "
                         f"{TOL_ORACLE} against the float64 oracle")
    sav = stats_row["saving"][:ORACLE_RUNS].double().cpu()
    if per_run:
        sav_err = float(((sav - host.saving).abs() / host.energy_ref).max())
    else:
        sav_err = abs(float((sav.mean() - host.saving.mean())
                            / host.energy_ref.mean()))
    if sav_err > TOL_ORACLE:
        raise Failed(f"{phase} {cfg.name} saving: {sav_err:.3e} of "
                     f"energy_ref > {TOL_ORACLE}")
    return max(gated, sav_err), worst_run, n_over


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import failures, optimize, prng, sweep
    from repro_torch.core.scenarios import (apply_policy, paper_scenarios,
                                            sparse_rendezvous_scenario)
    from repro_torch.kernels import _build
    from repro_torch.kernels import renewal_scan as rs

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card_line = card()

    # --- phase 1: build ----------------------------------------------------
    _build.load_library("renewal_scan", "renewal_scan.cu")
    info = _build.build_log["renewal_scan"]
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln]
    line("build", kernel="renewal_scan", seconds=f"{info['seconds']:.2f}",
         cached=info["cached"], card=repr(card_line))
    for r in regs:
        line("build", ptxas=repr(r))

    scen = list(paper_scenarios().values())
    grid_cfg = sparse_rendezvous_scenario()
    table = optimize.policy_grid(
        ckpt_interval=np.geomspace(2400.0, 19200.0, 7), mu1=[3.8, 6.0, 9.0],
        wait_mode=[0, 1])
    makespans = optimize.wall_makespan(GRID_WORK_S, table.ckpt_interval,
                                       grid_cfg.ckpt_duration)
    _, scen_stack = sweep._renewal_device_inputs(scen, torch.float32, dev)
    scen_ops = sweep._pack_kernel_inputs(scen_stack, MAKESPAN_S)
    grid_ops = sweep._pack_kernel_inputs(
        optimize.policy_inputs(grid_cfg, table, dev), makespans)

    # --- phase 2: kernel against its plain version, R not a multiple of 128
    r2, k2, n_nodes = 1000, FULL_EPOCHS, len(scen[0].survivors) + 1
    worst_abs = worst_rel = 0.0
    for label, ops, mtbf in (("scenarios", scen_ops, MTBF_S),
                             ("policies", grid_ops, GRID_MTBF_S)):
        g32, _ = failures.sample_renewal_gaps(
            failures.Exponential(mtbf), prng.PRNGKey(7), r2, k2, n_nodes, dev)
        gaps_t = g32.T.contiguous()
        gen = torch.Generator(device="cpu").manual_seed(11)
        felled = (torch.rand((k2, n_nodes - 1, r2), generator=gen) < 0.15
                  ).float().to(dev)
        for fel, comp in ((None, True), (felled, True), (None, False)):
            got = rs.renewal_scan(*ops, gaps_t, fel, compensated=comp)
            want = rs.renewal_scan_reference(*ops, gaps_t, fel,
                                             compensated=comp)
            torch.cuda.synchronize()
            max_abs, max_rel = compare_outputs(got, want)
            worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
            line("kernel-vs-plain", lanes=f"{label}:{ops[0].shape[0]}",
                 runs=r2, epochs=k2, felled=fel is not None,
                 compensated=comp, ints="exact",
                 max_abs_err=f"{max_abs:.6g}", max_rel_err=f"{max_rel:.3e}")

    # --- phase 3: the main path at the size users run ----------------------
    key = prng.PRNGKey(1)
    summaries, main_launches, (main_call,) = drive(
        rs, lambda: sweep.renewal_monte_carlo_scenarios(
            scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
            engine="kernel"))
    scen_args, scen_kw, ker_out = main_call
    max_abs, max_rel = compare_outputs(
        ker_out, rs.renewal_scan_reference(*scen_args, **scen_kw))
    worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
    line("main-path", call="renewal_monte_carlo_scenarios",
         scenarios=len(scen), runs=FULL_RUNS, epochs=FULL_EPOCHS,
         launches=main_launches, kernel_vs_plain="ints exact",
         max_abs_err=f"{max_abs:.6g}", max_rel_err=f"{max_rel:.3e}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, FULL_RUNS, n_nodes, FULL_EPOCHS, MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    row = lambda st, s: {f: st[f][s] for f in
                         ("energy_ref", "energy_int", "balanced_energy",
                          "end_time", "saving", "n_failures")}
    for s, cfg in enumerate(scen):
        err, _, _ = check_against_oracle("main-path", sweep, cfg,
                                         row(ker_out, s), gaps_o, failed_o,
                                         MAKESPAN_S)
        sm = summaries[cfg.name]
        check_summary(cfg.name, sm, ker_out, s)
        line("main-path", scenario=cfg.name,
             mean_failures=f"{sm.mean_failures:.6f}",
             mean_saving_pct=f"{sm.mean_saving_pct:.6f}",
             sleep_occupancy=f"{sm.sleep_occupancy:.6f}",
             oracle_rel_err=f"{err:.3e}")

    # kernel time at the main path's own operands, and its plain version's
    launch_main = lambda: rs.renewal_scan(*scen_args, **scen_kw)
    k_ms, host_ms = kernel_only_ms(launch_main, n=KERNEL_REPS)
    call_ms = statistics.median(cuda_ms(launch_main, reps=KERNEL_REPS))
    p_ms = statistics.median(cuda_ms(
        lambda: rs.renewal_scan_reference(*scen_args, **scen_kw),
        reps=3, warmup=1))
    slots = len(scen) * FULL_RUNS * FULL_EPOCHS * (n_nodes - 1)
    occurring = int(ker_out["valid"].sum()) * (n_nodes - 1)
    n_bytes = sum(t.numel() * t.element_size() for t in scen_args) \
        + sum(t.numel() * t.element_size() for t in ker_out.values())
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = occurring * FLOP_PER_DECISION / PEAK_FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    line("timing", kernel="renewal_scan", card=repr(card_line),
         kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
         call_ms_median=f"{call_ms:.5f}", plain_ms_median=f"{p_ms:.2f}",
         slots=slots, slot_decisions_per_s=f"{slots / (k_ms * 1e-3):.4e}",
         occurring_decisions=occurring,
         occurring_decisions_per_s=f"{occurring / (k_ms * 1e-3):.4e}",
         bytes=n_bytes, bound_ms=f"{bound_ms:.5f}",
         bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    # where the entry point's time goes: host clock around whole calls,
    # CUDA events around the device stages
    def wall_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    entry_ms = wall_ms(lambda: sweep.renewal_monte_carlo_scenarios(
        scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
        engine="kernel"), reps=5)
    sample_ms = statistics.median(cuda_ms(lambda: failures.sample_renewal_gaps(
        failures.Exponential(MTBF_S), key, FULL_RUNS, FULL_EPOCHS, n_nodes,
        dev), reps=5))
    pack_ms = wall_ms(lambda: sweep._pack_kernel_inputs(
        sweep._renewal_device_inputs(scen, torch.float32, dev)[1],
        MAKESPAN_S), reps=5)
    line("breakdown", call="renewal_monte_carlo_scenarios",
         card=repr(card_line), wall_ms_median=f"{entry_ms:.3f}",
         sample_ms=f"{sample_ms:.3f}", stack_and_pack_ms=f"{pack_ms:.3f}",
         kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
         wall_decisions_per_s=f"{slots / (entry_ms * 1e-3):.4e}")

    # --- phase 4: the 42-policy grid ---------------------------------------
    res, grid_launches, (grid_call,) = drive(
        rs, lambda: optimize.evaluate_policy_grid(
            grid_cfg, table, key, work_s=GRID_WORK_S, n_runs=FULL_RUNS,
            max_failures=FULL_EPOCHS, mtbf_s=GRID_MTBF_S, engine="kernel"))
    grid_args, grid_kw, grid_out = grid_call
    g_abs, g_rel = compare_outputs(
        grid_out, rs.renewal_scan_reference(*grid_args, **grid_kw))
    worst_abs, worst_rel = max(worst_abs, g_abs), max(worst_rel, g_rel)
    if not np.all(np.isfinite(res.mean_energy_j)):
        raise Failed("policy grid: non-finite energies")
    best = res.best
    knee = optimize.knee_point(res.mean_energy_j, res.mean_makespan_s)
    grid_wall_ms = wall_ms(lambda: optimize.evaluate_policy_grid(
        grid_cfg, table, key, work_s=GRID_WORK_S, n_runs=FULL_RUNS,
        max_failures=FULL_EPOCHS, mtbf_s=GRID_MTBF_S, engine="kernel"), reps=3)
    grid_k_ms, grid_host_ms = kernel_only_ms(
        lambda: rs.renewal_scan(*grid_args, **grid_kw), n=KERNEL_REPS)
    line("policy-grid-timing", card=repr(card_line),
         wall_ms_median=f"{grid_wall_ms:.3f}", kernel_ms=f"{grid_k_ms:.5f}",
         wrapper_host_ms=f"{grid_host_ms:.5f}",
         lanes=len(table), runs=FULL_RUNS, epochs=FULL_EPOCHS)
    line("policy-grid", policies=len(table), runs=FULL_RUNS,
         epochs=FULL_EPOCHS, launches=grid_launches,
         kernel_vs_plain="ints exact", max_abs_err=f"{g_abs:.6g}",
         max_rel_err=f"{g_rel:.3e}", argmin=best,
         argmin_policy=repr(table.policy(best)), knee=knee,
         knee_policy=repr(table.policy(knee)),
         argmin_mean_energy_j=f"{res.mean_energy_j[best]:.6e}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, FULL_RUNS, n_nodes, FULL_EPOCHS, GRID_MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    for p in sorted({0, best, len(table) - 1}):
        # the oracle gets the interval the kernel sees (its float32 value):
        # the model jumps by a rendezvous period at an exact wrap, so a
        # 1e-12 s difference in the interval can move a whole run
        pol = dict(table.policy(p),
                   ckpt_interval=float(np.float32(table.ckpt_interval[p])))
        cfg_p = apply_policy(grid_cfg, **pol)
        stats_row = {f: torch.as_tensor(getattr(res, f)[p]) for f in
                     ("energy_ref", "energy_int", "saving", "end_time",
                      "n_failures")}
        err, worst_run, n_over = check_against_oracle(
            "policy-grid", sweep, cfg_p, stats_row, gaps_o, failed_o,
            float(makespans[p]), per_run=False)
        line("policy-grid", policy=p, mean_oracle_rel_err=f"{err:.3e}",
             worst_run_rel_err=f"{worst_run:.3e}",
             runs_over_tol=f"{n_over}/{ORACLE_RUNS}")

    # --- phase 5: Weibull k=0.7 at equal MTBF -------------------------------
    proc = failures.Weibull.from_mtbf(0.7, MTBF_S)
    wstats, w_launches, (w_call,) = drive(
        rs, lambda: sweep.renewal_monte_carlo_device(
            scen, key, n_runs=WEIBULL_RUNS, max_failures=FULL_EPOCHS,
            process=proc, engine="kernel"))
    w_args, w_kw, w_out = w_call
    w_abs, w_rel = compare_outputs(
        w_out, rs.renewal_scan_reference(*w_args, **w_kw))
    worst_abs, worst_rel = max(worst_abs, w_abs), max(worst_rel, w_rel)
    line("weibull", scenarios=len(scen), runs=WEIBULL_RUNS,
         epochs=FULL_EPOCHS, launches=w_launches,
         kernel_vs_plain="ints exact", max_abs_err=f"{w_abs:.6g}",
         max_rel_err=f"{w_rel:.3e}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, WEIBULL_RUNS, n_nodes, FULL_EPOCHS, process=proc)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    wrow = lambda s: {f.name: getattr(wstats, f.name)[s]
                      for f in dataclasses.fields(wstats)}
    for s, cfg in enumerate(scen):
        err, _, _ = check_against_oracle("weibull", sweep, cfg, wrow(s),
                                         gaps_o, failed_o, MAKESPAN_S)
        line("weibull", scenario=cfg.name,
             mean_failures=f"{float(wstats.n_failures[s].float().mean()):.6f}",
             oracle_rel_err=f"{err:.3e}")

    line("done", seconds=f"{time.perf_counter() - t_start:.1f}",
         worst_kernel_vs_plain_rel=f"{worst_rel:.3e}")
    print(card_line)
    print(json.dumps({"kernels": [{
        "name": "renewal_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/renewal_scan.cu",
        "replaces": "src/repro/kernels/renewal_scan.py:322",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print('kernels: ["renewal_scan"]')
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
