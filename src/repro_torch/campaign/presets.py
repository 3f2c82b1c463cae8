"""Canonical campaign definitions (counterpart of
``repro.campaign.presets``).

Each preset is a zero-argument (or defaulted) builder returning a
``CampaignSpec``; the CLI (``python -m repro_torch.campaign``) resolves
presets by name from ``PRESETS``.  The constants are the reference's, so a
preset declares the same cells on both sides.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import energy_model as em
from repro_torch.core.scenarios import paper_scenarios
from repro_torch.campaign import spec
from repro_torch.fleet.profiles import cluster_scenario

# the fleet-cluster lowering rides the ordinary scenario registry, so
# `{"scenario": {"base": "fleet_cluster", "n_nodes": 8, ...}}` cells
# address, hash, and resume like any other scenario spec
spec.register_scenario("fleet_cluster", cluster_scenario)

# the reference's benchmark constants (its failure-sweep and policy
# benchmarks use these values)
RENEWAL_RUNS = 256
RENEWAL_MAX_FAILURES = 32
RENEWAL_MAKESPAN_D = 30.0
RENEWAL_MTBF_D = 7.0
RENEWAL_WEIBULL_K = 0.7

OPT_WORK_D = 2.0
OPT_MTBF_H = 8.0
OPT_N_RUNS = 64
OPT_MAX_FAILURES = 64
OPT_INTERVALS = tuple(float(t) for t in np.geomspace(2400.0, 19200.0, 7))
OPT_MU1 = (3.8, 6.0, 9.0)


def scenario_axis(names=None) -> spec.Matrix:
    """Axis over registry scenarios (default: the six Table-4 scenarios)."""
    names = tuple(names) if names is not None else tuple(paper_scenarios())
    return spec.axis("scenario",
                     [(n, {"scenario": {"base": n}}) for n in names])


def process_axis(specs: dict) -> spec.Matrix:
    """Axis over failure-process specs: label -> {"kind": ..., params}."""
    return spec.axis("process",
                     [(l, {"process": dict(p)}) for l, p in specs.items()])


def interval_axis(intervals) -> spec.Matrix:
    return spec.axis("interval", [
        (f"{t:g}", {"policy": {"ckpt_interval": float(t)}})
        for t in intervals])


def equal_mtbf_processes(mtbf_s: float, weibull_k: float = RENEWAL_WEIBULL_K) -> dict:
    return {
        "exp": {"kind": "exponential", "mtbf_s": mtbf_s},
        f"wb{weibull_k:g}".replace(".", ""): {
            "kind": "weibull", "k": weibull_k, "mtbf_s": mtbf_s},
    }


def table4_renewal(
    n_runs: int = RENEWAL_RUNS,
    max_failures: int = RENEWAL_MAX_FAILURES,
    makespan_d: float = RENEWAL_MAKESPAN_D,
    mtbf_d: float = RENEWAL_MTBF_D,
    weibull: bool = False,
) -> spec.CampaignSpec:
    """The six Table-4 scenarios under whole-run renewal Monte-Carlo —
    the matrix behind ``failure_sweep/renewal_*`` rows (exponential), with
    an optional equal-MTBF Weibull lane for the process axis."""
    mtbf_s = mtbf_d * 24 * 3600.0
    procs = equal_mtbf_processes(mtbf_s)
    if not weibull:
        procs = {"exp": procs["exp"]}
    m = scenario_axis() * process_axis(procs)
    return spec.campaign("table4_renewal", m, base={
        "run": {"n_runs": n_runs, "max_failures": max_failures,
                "makespan_s": makespan_d * 24 * 3600.0},
        "seed": 0,
    })


def policy_grid(
    n_runs: int = OPT_N_RUNS,
    max_failures: int = OPT_MAX_FAILURES,
    work_d: float = OPT_WORK_D,
    mtbf_h: float = OPT_MTBF_H,
) -> spec.CampaignSpec:
    """The optimizer benchmark grid — interval x mu1 x wait_mode on the
    sparse-rendezvous workload, equal useful work per policy.  Cell order matches
    ``optimize.policy_grid``'s C-order, so record ``p`` is grid row ``p``.
    """
    m = (interval_axis(OPT_INTERVALS)
         * spec.axis("mu1", [(f"{v:g}", {"policy": {"mu1": v}})
                             for v in OPT_MU1])
         * spec.axis("wait", [
             ("active", {"policy": {"wait_mode": int(em.WaitMode.ACTIVE)}}),
             ("idle", {"policy": {"wait_mode": int(em.WaitMode.IDLE)}})]))
    return spec.campaign("policy_grid", m, base={
        "scenario": {"base": "sparse_rendezvous"},
        "process": {"kind": "exponential", "mtbf_s": mtbf_h * 3600.0},
        "run": {"n_runs": n_runs, "max_failures": max_failures,
                "work_s": work_d * 24 * 3600.0},
        "seed": 1,
    })


def process_shift(
    n_runs: int = OPT_N_RUNS,
    max_failures: int = OPT_MAX_FAILURES,
    work_d: float = OPT_WORK_D,
    mtbf_h: float = OPT_MTBF_H,
) -> spec.CampaignSpec:
    """Interval-only grid under exponential vs equal-MTBF Weibull(0.7) —
    the optimum-shift measurement behind ``optimize_policy/process_shift``."""
    m = (interval_axis(OPT_INTERVALS)
         * process_axis(equal_mtbf_processes(mtbf_h * 3600.0)))
    return spec.campaign("process_shift", m, base={
        "scenario": {"base": "sparse_rendezvous"},
        "run": {"n_runs": n_runs, "max_failures": max_failures,
                "work_s": work_d * 24 * 3600.0},
        "seed": 1,
    })


def topology_axis(specs: dict) -> spec.Matrix:
    """Axis over correlated-shock topology specs: label -> topology dict
    (``{"kind": "rack", ...}``); a ``None`` value means iid sampling."""
    return spec.axis("topology", [
        (l, {"topology": dict(t)} if t is not None else {})
        for l, t in specs.items()])


def table4_correlated(
    n_runs: int = RENEWAL_RUNS,
    max_failures: int = RENEWAL_MAX_FAILURES,
    makespan_d: float = RENEWAL_MAKESPAN_D,
    mtbf_d: float = RENEWAL_MTBF_D,
    shock_mtbs_d: float = 10.0,
    p_kill: float = 0.6,
) -> spec.CampaignSpec:
    """The six Table-4 scenarios under Weibull renewal with an iid lane
    and a rack-correlated lane (shared shocks, ``core.topology``) — the
    matrix behind the correlated-vs-iid energy comparison."""
    mtbf_s = mtbf_d * 24 * 3600.0
    m = scenario_axis() * topology_axis({
        "iid": None,
        "rack": {"kind": "rack", "rack_size": 3,
                 "shock_mtbs_s": shock_mtbs_d * 24 * 3600.0,
                 "p_kill": p_kill, "age_boost_s": 3600.0},
    })
    return spec.campaign("table4_correlated", m, base={
        "process": {"kind": "weibull", "k": RENEWAL_WEIBULL_K,
                    "mtbf_s": mtbf_s},
        "run": {"n_runs": n_runs, "max_failures": max_failures,
                "makespan_s": makespan_d * 24 * 3600.0},
        "seed": 0,
    })


def fleet(
    n_runs: int = OPT_N_RUNS,
    max_failures: int = OPT_MAX_FAILURES,
    work_d: float = OPT_WORK_D,
    mtbf_d: float = 14.0,
) -> spec.CampaignSpec:
    """Matrix over cluster profiles — node count x power class under the
    balanced ``fleet_cluster`` lowering (``fleet.ClusterProfile``),
    the campaign-side view of the fleet-advisory cluster axis: the same
    heterogeneity the advisor serves online,
    addressed and stored as an offline experiment matrix."""
    m = (spec.axis("nodes", [
            (f"n{n}", {"scenario": {"base": "fleet_cluster", "n_nodes": n}})
            for n in (4, 8)])
         * spec.axis("power", [
            (f"x{s:g}".replace(".", ""),
             {"scenario": {"power_scale": s}})
            for s in (0.8, 1.0, 1.25)]))
    return spec.campaign("fleet", m, base={
        "process": {"kind": "exponential", "mtbf_s": mtbf_d * 24 * 3600.0},
        "run": {"n_runs": n_runs, "max_failures": max_failures,
                "work_s": work_d * 24 * 3600.0},
        "seed": 0,
    })


def smoke() -> spec.CampaignSpec:
    """A four-cell matrix sized for smoke tests: two scenarios x
    {exponential, Weibull} at small run counts."""
    mtbf_s = 7.0 * 24 * 3600.0
    m = (scenario_axis(("scenario2_long_reexec",
                        "scenario4_short_active_waits"))
         * process_axis(equal_mtbf_processes(mtbf_s)))
    return spec.campaign("smoke", m, base={
        "run": {"n_runs": 16, "max_failures": 8,
                "makespan_s": 10.0 * 24 * 3600.0},
        "seed": 0,
    })


PRESETS = {
    "smoke": smoke,
    "table4_renewal": table4_renewal,
    "table4_correlated": table4_correlated,
    "policy_grid": policy_grid,
    "process_shift": process_shift,
    "fleet": fleet,
}
