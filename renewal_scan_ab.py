"""Time two builds of the renewal kernel on one NVIDIA GPU, in turns.

    python3 renewal_scan_ab.py --baseline DIR [--rounds 2]

Builds this checkout's ``src/repro_torch/kernels/csrc/renewal_scan.cu`` and
the same file of another checkout ``DIR`` (a commit unpacked with
``git archive <commit> | tar -x -C DIR``), both with this checkout's flags,
one nvcc each, started together.  It captures the operands of the renewal
path's three launches as ``chip_smoke.py`` makes them (the main path: six
Table-4 scenarios x 4096 runs x 64 epochs; the 42-policy grid; Weibull
failures, 1024 runs), holds both builds bit-equal to each other and to the
plain version on each, and times each launch with ``chip_smoke.py``'s
``kernel_only_ms`` in the order baseline, this, this, baseline, per round.
Then it times this build's two mappings of runs to lanes (one lane per run,
one lane per survivor) on those operands and on the grid's cut to 2..42
lanes, beside the mapping the kernel picks.  Prints one ``[ab]`` line per
launch and one ``[mapping]`` line per launch size with every time, the
card's SM clock under the grid's load, and the card as ``nvidia-smi``
names it.  Exits non-zero
without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("renewal_scan_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import failures, optimize, prng, sweep
    from repro_torch.core.scenarios import (paper_scenarios,
                                            sparse_rendezvous_scenario)
    from repro_torch.kernels import _build
    from repro_torch.kernels import renewal_scan as rs

    card_line = cs.card()
    base_csrc = args.baseline / "src" / "repro_torch" / "kernels" / "csrc"
    name, source, flags = rs.LIBRARY
    with ThreadPoolExecutor(max_workers=2) as pool:
        base_job = pool.submit(_build.load_library, f"{name}_baseline", source,
                               flags, base_csrc)
        _build.load_library(*rs.LIBRARY)
        base_lib = base_job.result()
    for label in (name, f"{name}_baseline"):
        for fn in cs.ptxas_functions(_build.build_log[label]["ptxas"]):
            cs.line("build", library=label, **fn)

    key = prng.PRNGKey(1)
    scen = list(paper_scenarios().values())
    grid_cfg = sparse_rendezvous_scenario()
    table = optimize.policy_grid(
        ckpt_interval=np.geomspace(2400.0, 19200.0, 7),
        mu1=[3.8, 6.0, 9.0], wait_mode=[0, 1])
    paths = {
        "main-path": lambda: sweep.renewal_monte_carlo_scenarios(
            scen, key, n_runs=cs.FULL_RUNS, max_failures=cs.FULL_EPOCHS,
            engine="kernel"),
        "policy-grid": lambda: optimize.evaluate_policy_grid(
            grid_cfg, table, key, work_s=cs.GRID_WORK_S, n_runs=cs.FULL_RUNS,
            max_failures=cs.FULL_EPOCHS, mtbf_s=cs.GRID_MTBF_S,
            engine="kernel"),
        "weibull": lambda: sweep.renewal_monte_carlo_device(
            scen, key, n_runs=cs.WEIBULL_RUNS, max_failures=cs.FULL_EPOCHS,
            process=failures.Weibull.from_mtbf(0.7, cs.MTBF_S),
            stats=True, engine="kernel"),
    }
    captured = {}
    for label, path in paths.items():
        _, _, ((k_args, k_kw, _),) = cs.drive(rs, path)
        n_surv = k_args[1].shape[2]
        comp = k_kw.get("compensated", True)
        felled = k_args[4] if len(k_args) > 4 else k_kw.get("felled")
        ops = k_args[:4]
        captured[label] = (ops, felled, comp)
        this = lambda: rs.renewal_scan(*ops, felled, compensated=comp)
        base = lambda: rs._launch_cuda(*ops, felled, comp, lib=base_lib)
        want = rs.renewal_scan_reference(*ops, felled, compensated=comp)
        got_this, got_base = this(), base()
        torch.cuda.synchronize()
        for got in (got_this, got_base):
            cs.compare_outputs(got, want)
            for field, w in want.items():
                if not torch.equal(got[field].view(torch.int32),
                                   w.view(torch.int32)):
                    raise cs.Failed(f"{label}: {field} is not bit-equal to "
                                    f"the plain version")
        times = {"baseline": [], "this": []}
        for _ in range(args.rounds):
            for who in ("baseline", "this", "this", "baseline"):
                ms, _ = cs.kernel_only_ms(base if who == "baseline" else this,
                                          n=cs.KERNEL_REPS)
                times[who].append(ms)
        bound_ms, bound_by, _, occurring = cs.renewal_bound(ops, want, n_surv)
        med = {who: statistics.median(t) for who, t in times.items()}
        cs.line("ab", launch=label, card=repr(card_line),
                lanes=ops[0].shape[0], runs=ops[3].shape[1],
                epochs=ops[3].shape[0], occurring_decisions=occurring,
                baseline_ms=[f"{t:.5f}" for t in times["baseline"]],
                this_ms=[f"{t:.5f}" for t in times["this"]],
                baseline_median_ms=f"{med['baseline']:.5f}",
                this_median_ms=f"{med['this']:.5f}",
                speedup=f"{med['baseline'] / med['this']:.3f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                bit_equal="both")
        if label == "policy-grid":
            cs.line("clocks", during=f"{label} x2000 (this build)",
                    card=repr(card_line),
                    sm_clock_max_clock_power_temperature=repr(
                        cs.loaded_clocks(this, 2000)))

    # this build's two mappings of runs to lanes against the launch size:
    # the main path's and Weibull's operands, and the grid's cut to its
    # first P lanes; each timed in turns (one lane, per survivor, per
    # survivor, one lane) beside the mapping the kernel picks
    lib = _build.load_library(*rs.LIBRARY)
    pick = lib.renewal_scan_lanes_per_run
    pick.argtypes = [ctypes.c_int] * 3
    grid_ops, grid_fel, grid_comp = captured["policy-grid"]
    cases = [(label, *captured[label]) for label in ("weibull", "main-path")]
    for n_pol in (2, 4, 8, 12, 16, 24, 32, 42):
        cut = tuple(t[:n_pol].contiguous() for t in grid_ops[:3])
        cases.append((f"policy-grid[:{n_pol}]", cut + (grid_ops[3],),
                      grid_fel, grid_comp))
    for label, ops, felled, comp in cases:
        n, lanes_total, n_runs = ops[1].shape[2], ops[0].shape[0], ops[3].shape[1]
        times = {1: [], n: []}
        for lanes in (1, n, n, 1):
            ms, _ = cs.kernel_only_ms(
                lambda lanes=lanes: rs._launch_cuda(*ops, felled, comp,
                                                    lanes=lanes),
                n=cs.KERNEL_REPS)
            times[lanes].append(ms)
        med = {k: statistics.median(v) for k, v in times.items()}
        cs.line("mapping", operands=label, card=repr(card_line),
                runs_total=lanes_total * n_runs, survivors=n,
                one_lane_ms=[f"{t:.5f}" for t in times[1]],
                per_survivor_ms=[f"{t:.5f}" for t in times[n]],
                faster=1 if med[1] <= med[n] else n,
                kernel_picks=pick(n, lanes_total, n_runs))
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
