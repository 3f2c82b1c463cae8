"""Campaign CLI: declare -> run -> interrupt -> resume from the shell.

    python -m repro_torch.campaign list
    python -m repro_torch.campaign run --preset smoke --store STORE
        [--device cuda|cpu] [--limit N] [--expect-skipped N]
        [--chunk-budget-mb M] [--table]
    python -m repro_torch.campaign show --store STORE
    python -m repro_torch.campaign diff STORE_A STORE_B

``run`` skips cells whose content address is already stored (resume) and
computes on ``--device`` (default ``cuda``, which raises without a card;
``cpu`` runs the plain path); ``--limit`` computes at most N pending cells
(a deterministic interrupted run); ``--expect-skipped`` asserts resume
correctness (exit 1 on mismatch); ``--limit-seed S`` /
``--expect-skipped-seed S`` derive that N pseudo-randomly from S, so a
chaos run kills the campaign at a different cell per seed while both
halves agree on where; ``diff`` exits 1 unless both stores hold
bit-identical deterministic results for every shared cell.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

from repro_torch.campaign import analyze, presets, runner, store as store_mod


_SHOW_COLUMNS = (
    ("cell", lambda r: "/".join(
        f"{a}={l}" for a, l in sorted(r.get("labels", {}).items()))),
    ("E[failures]", ("result.mean_failures", ".1f")),
    ("E[saving] kWh", lambda r:
        f"{analyze.get(r, 'result.mean_saving_j', 0.0) / 3.6e6:.2f}"),
    ("save %", ("result.mean_saving_pct", ".2f")),
    ("trunc", ("result.truncated_rate", ".2f")),
    ("key", lambda r: r["key"][:12]),
)


def _cmd_list(_args) -> int:
    for name, build in sorted(presets.PRESETS.items()):
        print(f"{name:>16}  {len(build())} cells — "
              f"{(build.__doc__ or '').strip().splitlines()[0]}")
    return 0


def _seeded_cut(seed: int, n_total: int) -> int:
    """The chaos run's kill point: a pseudo-random cell count in
    [1, n_total) derived only from the seed, so the interrupted run
    (--limit-seed S) and the resumed run (--expect-skipped-seed S) agree
    on where the kill happened without sharing state."""
    return random.Random(seed).randrange(1, max(n_total, 2))


def _cmd_run(args) -> int:
    build = presets.PRESETS.get(args.preset)
    if build is None:
        print(f"unknown preset {args.preset!r}; "
              f"known: {sorted(presets.PRESETS)}")
        return 1
    campaign = build()
    limit, expect_skipped = args.limit, args.expect_skipped
    if args.limit_seed is not None:
        limit = _seeded_cut(args.limit_seed, len(campaign.cells))
    if args.expect_skipped_seed is not None:
        expect_skipped = _seeded_cut(args.expect_skipped_seed,
                                     len(campaign.cells))
    store = store_mod.ResultStore(args.store) if args.store else None
    report = runner.run_campaign(
        campaign, store, limit=limit,
        chunk_budget_mb=args.chunk_budget_mb, progress=print,
        device=args.device)
    if expect_skipped is not None and report.n_skipped != expect_skipped:
        print(f"resume check FAILED: expected {expect_skipped} skipped "
              f"cells, got {report.n_skipped}")
        return 1
    if args.table:
        print()
        print(analyze.summary_table(report.records, _SHOW_COLUMNS,
                                    fmt="text"))
    return 0


def _cmd_show(args) -> int:
    store = store_mod.ResultStore(args.store)
    records = sorted(store.records(),
                     key=lambda r: sorted(r.get("labels", {}).items()))
    if not records:
        print(f"no records under {args.store}")
        return 0
    print(analyze.summary_table(records, _SHOW_COLUMNS, fmt="text"))
    return 0


def _cmd_diff(args) -> int:
    diffs = store_mod.diff_stores(args.store_a, args.store_b)
    for d in diffs:
        print(d)
    if diffs:
        print(f"{len(diffs)} difference(s)")
        return 1
    n = len(store_mod.ResultStore(args.store_a))
    print(f"stores match: {n} cells, deterministic results bit-identical")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.campaign",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list presets")

    p_run = sub.add_parser("run", help="run a preset campaign")
    p_run.add_argument("--preset", required=True)
    p_run.add_argument("--store", default=None,
                       help="result-store directory (omit: in-memory only)")
    p_run.add_argument("--limit", type=int, default=None,
                       help="compute at most N pending cells")
    p_run.add_argument("--expect-skipped", type=int, default=None,
                       help="exit 1 unless exactly N cells were resumed")
    p_run.add_argument("--limit-seed", type=int, default=None,
                       help="derive --limit pseudo-randomly from a seed "
                            "(chaos-run kill point)")
    p_run.add_argument("--expect-skipped-seed", type=int, default=None,
                       help="derive --expect-skipped from the same seed")
    p_run.add_argument("--chunk-budget-mb", type=float,
                       default=runner.DEFAULT_CHUNK_BUDGET_MB)
    p_run.add_argument("--device", default="cuda",
                       help="torch device to compute on (default cuda; "
                            "cpu runs the plain path)")
    p_run.add_argument("--table", action="store_true",
                       help="print a result table after the run")

    p_show = sub.add_parser("show", help="print a store's records")
    p_show.add_argument("--store", required=True)

    p_diff = sub.add_parser("diff",
                            help="compare two stores' deterministic results")
    p_diff.add_argument("store_a")
    p_diff.add_argument("store_b")

    args = ap.parse_args(argv)
    return {"list": _cmd_list, "run": _cmd_run,
            "show": _cmd_show, "diff": _cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `show | head` closing stdout early
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
