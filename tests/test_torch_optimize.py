"""PyTorch port: the operator entry points of ``core.optimize`` against the
reference — ``default_policy_table``, ``cem_refine`` (with ``warm=``),
``optimize_policy`` and ``optimize_across_processes`` — and their device
contract.

Bars, each against the reference at the same key (each side samples its
own histories; the uniforms are bit-exact and ``log1p``/``pow`` may differ
by an ulp, so a few gaps per key differ by an ulp):

  * ``cem_refine`` on a 3-policy grid at 16 runs x 8 epochs: the same best
    knobs and the same per-iteration sampling means (the Gaussian is numpy
    ``default_rng(seed)`` on both sides), per-iteration scores within the
    scan's 1e-9 relative bar.  No elite choice flipped on a near-tie at
    these keys; the monotone and no-worse-than-seed invariants are held
    as well;
  * ``optimize_policy``: best, Pareto front and knee indices equal, means
    within 1e-9 (refined best within 1e-9 too);
  * ``equal_mtbf_processes``: parameters and trace gaps exactly equal;
  * ``optimize_across_processes``: per process the argmin, Pareto front
    and knee equal, means within 1e-9 (exponential, the trace) and 1e-8
    (the Weibull, observed 3.6e-9: its ``pow`` gaps differ by an ulp more
    often).
"""
import numpy as np
import pytest
import torch

from torch_port_ref import (load_reference, requires_cuda, skip_without_cuda,
                            to_np)

from repro_torch import spans
from repro_torch.core import failures as F
from repro_torch.core import optimize as O
from repro_torch.core import prng
from repro_torch.core import scenarios as SC
from repro_torch.core import sweep as S

TOL = 1e-9
WORK_S = 1 * 24 * 3600.0
MTBF_S = 8 * 3600.0
KW = dict(work_s=WORK_S, n_runs=16, max_failures=8, mtbf_s=MTBF_S)
INTERVALS = [3600.0, 7200.0, 14400.0]
BOUNDS = {"ckpt_interval": (2400.0, 12000.0)}
CEM = dict(bounds=BOUNDS, n_iters=3, population=8, seed=3)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a / b - 1)))


def _knobs(policy: dict) -> dict:
    return {k: policy[k] for k in ("ckpt_interval", "mu1", "mu2",
                                   "wait_mode", "move_ahead_frac")}


def _seed_policies(ref, key: int):
    cfg_t = SC.sparse_rendezvous_scenario()
    cfg_j = ref.scenarios.sparse_rendezvous_scenario()
    rt = O.evaluate_policy_grid(cfg_t, O.policy_grid(ckpt_interval=INTERVALS),
                                prng.PRNGKey(key), device="cpu", **KW)
    rj = ref.optimize.evaluate_policy_grid(
        cfg_j, ref.optimize.policy_grid(ckpt_interval=INTERVALS),
        ref.jax.random.PRNGKey(key), **KW)
    assert rt.best == rj.best
    return cfg_t, cfg_j, rt.policy(rt.best), rj.policy(rj.best)


def test_default_policy_table_matches_reference(ref):
    for cfg_t, cfg_j in ((SC.sparse_rendezvous_scenario(),
                          ref.scenarios.sparse_rendezvous_scenario()),
                         (SC.paper_scenarios()["scenario2_long_reexec"],
                          ref.scenarios.paper_scenarios()["scenario2_long_reexec"])):
        for mtbf in (MTBF_S, 14 * 24 * 3600.0):
            ours = O.default_policy_table(cfg_t, mtbf)
            theirs = ref.optimize.default_policy_table(cfg_j, mtbf)
            for f in ("ckpt_interval", "mu1", "mu2", "wait_mode",
                      "move_ahead_frac"):
                np.testing.assert_array_equal(getattr(ours, f),
                                              getattr(theirs, f))
    assert O.CEM_KNOBS == ref.optimize.CEM_KNOBS


@pytest.mark.parametrize("key", [0, 3])
def test_cem_refine_matches_reference(ref, key):
    cfg_t, cfg_j, seed_t, seed_j = _seed_policies(ref, key)
    ours = O.cem_refine(cfg_t, prng.PRNGKey(key), init=seed_t, device="cpu",
                        **CEM, **KW)
    theirs = ref.optimize.cem_refine(cfg_j, ref.jax.random.PRNGKey(key),
                                     init=seed_j, **CEM, **KW)
    assert ours.n_evaluations == theirs.n_evaluations == 3 * 9
    assert _knobs(ours.best) == _knobs(theirs.best)
    assert _rel(ours.best["mean_energy_j"], theirs.best["mean_energy_j"]) <= TOL
    assert len(ours.iterations) == len(theirs.iterations)
    for a, b in zip(ours.iterations, theirs.iterations):
        assert a["mean"] == b["mean"] and a["std"] == b["std"]
        assert _rel(a["best_score"], b["best_score"]) <= TOL
        assert _rel(a["best_makespan_s"], b["best_makespan_s"]) <= TOL
    # the invariants, held within the port
    scores = [h["best_score"] for h in ours.iterations]
    assert all(y <= x for x, y in zip(scores, scores[1:])), scores
    assert ours.best["mean_energy_j"] <= seed_t["mean_energy_j"]


def test_cem_refine_deterministic_bounds_and_floor():
    cfg = SC.sparse_rendezvous_scenario()
    seed = O.evaluate_policy_grid(cfg, O.policy_grid(ckpt_interval=INTERVALS),
                                  prng.PRNGKey(0), device="cpu", **KW).policy(0)
    kw = dict(init=seed, device="cpu", n_iters=2, population=6, seed=1, **KW)
    a = O.cem_refine(cfg, prng.PRNGKey(0), bounds=BOUNDS, **kw)
    b = O.cem_refine(cfg, prng.PRNGKey(0), bounds=BOUNDS, **kw)
    assert a.best == b.best and a.iterations == b.iterations
    assert a.seed_policy == seed
    # a box reaching below the sawtooth floor is clipped to it, not fatal
    floor = O.interval_floor(cfg)
    low = O.cem_refine(cfg, prng.PRNGKey(0),
                       bounds={"ckpt_interval": (1.0, 9000.0)}, **kw)
    assert low.best["ckpt_interval"] >= floor
    with pytest.raises(ValueError, match="floor"):
        O.cem_refine(cfg, prng.PRNGKey(0),
                     bounds={"ckpt_interval": (1.0, floor / 2)}, **kw)
    with pytest.raises(ValueError, match="CEM"):
        O.cem_refine(cfg, prng.PRNGKey(0), bounds={"wait_mode": (0, 1)},
                     **kw)
    with pytest.raises(ValueError, match="at least one"):
        O.cem_refine(cfg, prng.PRNGKey(0), bounds={}, **kw)


def test_cem_refine_warm_start_resumes_posterior(ref):
    """``warm=`` resumes the Gaussian from the previous posterior (std
    floored at 2 % of the box), never regresses from its init under CRN,
    replays deterministically, and matches the reference's warm start."""
    cfg_t, cfg_j, seed_t, seed_j = _seed_policies(ref, 0)
    cold_kw = dict(bounds=BOUNDS, n_iters=2, population=8, seed=3, **KW)
    cold = O.cem_refine(cfg_t, prng.PRNGKey(0), init=seed_t, device="cpu",
                        **cold_kw)
    warm_kw = dict(cold_kw, n_iters=1)
    warm = O.cem_refine(cfg_t, prng.PRNGKey(0), init=cold.best, warm=cold,
                        device="cpu", **warm_kw)
    assert warm.best["mean_energy_j"] <= cold.best["mean_energy_j"]
    lo, hi = BOUNDS["ckpt_interval"]
    resumed = max(cold.iterations[-1]["std"]["ckpt_interval"], 0.02 * (hi - lo))
    assert resumed < 0.25 * (hi - lo)
    again = O.cem_refine(cfg_t, prng.PRNGKey(0), init=cold.best, warm=cold,
                         device="cpu", **warm_kw)
    assert again.best == warm.best and again.iterations == warm.iterations
    cold_j = ref.optimize.cem_refine(cfg_j, ref.jax.random.PRNGKey(0),
                                     init=seed_j, **cold_kw)
    warm_j = ref.optimize.cem_refine(cfg_j, ref.jax.random.PRNGKey(0),
                                     init=cold_j.best, warm=cold_j, **warm_kw)
    assert _knobs(warm.best) == _knobs(warm_j.best)
    assert warm.iterations[0]["mean"] == warm_j.iterations[0]["mean"]
    assert _rel(warm.iterations[0]["best_score"],
                warm_j.iterations[0]["best_score"]) <= TOL


def _assert_optimum_matches(ours, theirs, tol=TOL):
    assert ours.grid.best == theirs.grid.best
    np.testing.assert_array_equal(ours.pareto, np.asarray(theirs.pareto))
    assert _knobs(ours.knee) == _knobs(theirs.knee)
    assert _knobs(ours.best) == _knobs(theirs.best)
    np.testing.assert_array_equal(ours.grid.n_failures,
                                  np.asarray(theirs.grid.n_failures))
    assert _rel(ours.grid.mean_energy_j, theirs.grid.mean_energy_j) <= tol
    assert _rel(ours.grid.mean_makespan_s, theirs.grid.mean_makespan_s) <= tol
    assert ours.scenario == theirs.scenario
    assert ours.process_label == theirs.process_label
    assert ours.mtbf_s == pytest.approx(theirs.mtbf_s, rel=1e-12)


def test_optimize_policy_matches_reference(ref):
    cfg_t = SC.sparse_rendezvous_scenario()
    cfg_j = ref.scenarios.sparse_rendezvous_scenario()
    grid = dict(ckpt_interval=[2400.0, 4800.0, 9600.0], wait_mode=[0, 1])
    kw = dict(work_s=WORK_S, mtbf_s=MTBF_S, n_runs=16, max_failures=8)
    ours = O.optimize_policy(cfg_t, prng.PRNGKey(3), table=O.policy_grid(**grid),
                             device="cpu", **kw)
    theirs = ref.optimize.optimize_policy(
        cfg_j, ref.jax.random.PRNGKey(3),
        table=ref.optimize.policy_grid(**grid), **kw)
    _assert_optimum_matches(ours, theirs)
    assert ours.cem is None and ours.best == ours.grid.policy(ours.grid.best)
    knee = O.knee_point(ours.grid.mean_energy_j, ours.grid.mean_makespan_s,
                        ours.pareto)
    assert ours.knee == ours.grid.policy(knee) and knee in ours.pareto.tolist()
    # the default table and key, refined with CEM
    cem_kw = {"n_iters": 2, "population": 6}
    ours_r = O.optimize_policy(cfg_t, refine=True, cem_kw=cem_kw,
                               device="cpu", **kw)
    theirs_r = ref.optimize.optimize_policy(cfg_j, refine=True, cem_kw=cem_kw,
                                            **kw)
    assert len(ours_r.grid) == len(theirs_r.grid) == 42
    assert ours_r.cem is not None
    assert _knobs(ours_r.best) == _knobs(theirs_r.best)
    assert _rel(ours_r.best["mean_energy_j"],
                theirs_r.best["mean_energy_j"]) <= TOL
    assert ours_r.best["mean_energy_j"] <= ours_r.grid.mean_energy_j.min()
    assert ours_r.cem.seed_policy == ours_r.grid.policy(ours_r.grid.best)


def test_optimize_policy_kernel_grid_stage():
    """``engine="kernel"`` runs the grid stage through the renewal kernel
    (its plain version on the CPU), one call; the refinement stays on the
    scan.  Means within the kernel's 1e-4 of the scan's grid."""
    cfg = SC.sparse_rendezvous_scenario()
    table = O.policy_grid(ckpt_interval=[2700.0, 5400.0, 10800.0],
                          wait_mode=[0, 1])
    kw = dict(table=table, work_s=WORK_S, mtbf_s=MTBF_S, n_runs=32,
              max_failures=16, device="cpu")
    scan = O.optimize_policy(cfg, prng.PRNGKey(2), **kw)
    kern = O.optimize_policy(cfg, prng.PRNGKey(2), engine="kernel", **kw)
    assert _rel(kern.grid.mean_energy_j, scan.grid.mean_energy_j) <= 1e-4
    np.testing.assert_array_equal(kern.grid.n_failures, scan.grid.n_failures)
    assert kern.grid.best == scan.grid.best
    refined = O.optimize_policy(cfg, prng.PRNGKey(2), engine="kernel",
                                refine=True, cem_kw={"n_iters": 1,
                                                     "population": 4}, **kw)
    again = O.cem_refine(cfg, prng.PRNGKey(2), init=refined.grid.policy(
        refined.grid.best), bounds={"ckpt_interval": (2700.0, 10800.0)},
        n_iters=1, population=4, work_s=WORK_S, n_runs=32, max_failures=16,
        process=F.Exponential(MTBF_S), device="cpu")
    assert refined.best == again.best      # CEM on the scan, as the reference
    with pytest.raises(ValueError, match="unknown engine"):
        O.optimize_policy(cfg, prng.PRNGKey(2), engine="pallas", **kw)


def test_equal_mtbf_processes_match_reference(ref):
    for mtbf, k in ((MTBF_S, 0.7), (6 * 3600.0, 0.9)):
        ours = O.equal_mtbf_processes(mtbf, weibull_k=k)
        theirs = ref.optimize.equal_mtbf_processes(mtbf, weibull_k=k)
        assert list(ours) == list(theirs)
        for name, p in ours.items():
            q = theirs[name]
            assert type(p).__name__ == type(q).__name__
            for f in ("mtbf_s", "k", "scale_s", "gaps"):
                if hasattr(q, f):
                    np.testing.assert_array_equal(getattr(p, f),
                                                  np.asarray(getattr(q, f)))
            assert np.isclose(float(np.mean(p.mean_s())), mtbf, rtol=1e-6)
            assert p.label() == q.label()


def test_optimize_across_processes_matches_reference(ref):
    cfg_t = SC.sparse_rendezvous_scenario()
    cfg_j = ref.scenarios.sparse_rendezvous_scenario()
    grid = dict(ckpt_interval=[2400.0, 4800.0, 9600.0])
    kw = dict(mtbf_s=MTBF_S, work_s=WORK_S, n_runs=16, max_failures=8)
    ours = O.optimize_across_processes(cfg_t, table=O.policy_grid(**grid),
                                       device="cpu", **kw)
    theirs = ref.optimize.optimize_across_processes(
        cfg_j, table=ref.optimize.policy_grid(**grid), **kw)
    assert list(ours) == list(theirs) == ["exponential", "weibull_k0.7",
                                          "trace"]
    for name in ours:
        _assert_optimum_matches(ours[name], theirs[name],
                                1e-8 if name.startswith("weibull") else TOL)


CUDA_DEFAULT_CALLS = {
    "optimize_policy": lambda: O.optimize_policy(
        SC.sparse_rendezvous_scenario(), n_runs=2, max_failures=2),
    "cem_refine": lambda: O.cem_refine(
        SC.sparse_rendezvous_scenario(), prng.PRNGKey(0),
        init=O.policy_grid(ckpt_interval=[3600.0]).policy(0),
        bounds=BOUNDS, work_s=WORK_S, mtbf_s=MTBF_S),
    "optimize_across_processes": lambda: O.optimize_across_processes(
        SC.sparse_rendezvous_scenario(), mtbf_s=MTBF_S),
    "evaluate_policy_grid(clusters=)": lambda: O.evaluate_policy_grid(
        None, O.policy_grid(ckpt_interval=[3600.0]), prng.PRNGKey(0),
        work_s=WORK_S, mtbf_s=MTBF_S,
        clusters=[SC.sparse_rendezvous_scenario()]),
    "FleetAdvisor": lambda: __import__(
        "repro_torch.fleet", fromlist=["FleetAdvisor"]).FleetAdvisor(),
    "run_campaign": lambda: __import__(
        "repro_torch.campaign", fromlist=["run_campaign"]).run_campaign(
        __import__("repro_torch.campaign.presets",
                   fromlist=["smoke"]).smoke()),
}


@pytest.mark.parametrize("name", sorted(CUDA_DEFAULT_CALLS))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Each new entry point defaults to ``device="cuda"``: without a card
    it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDA_DEFAULT_CALLS[name]()


@requires_cuda
def test_optimize_policy_on_card():
    """On the card: the kernel grid stage is one launch, each grid lane is
    bit-equal to a standalone scan call, and the kernel grid's means are
    within 1e-4 of the scan's."""
    skip_without_cuda()
    from repro_torch.kernels import renewal_scan as rs

    cfg = SC.sparse_rendezvous_scenario()
    table = O.policy_grid(ckpt_interval=[2700.0, 5400.0, 10800.0],
                          wait_mode=[0, 1])
    kw = dict(table=table, work_s=WORK_S, mtbf_s=MTBF_S, n_runs=256,
              max_failures=32, device="cuda")
    scan = O.optimize_policy(cfg, prng.PRNGKey(2), **kw)
    spans.reset_counts()
    kern = O.optimize_policy(cfg, prng.PRNGKey(2), engine="kernel", **kw)
    assert rs.LAUNCHES["renewal_scan"] == 1
    assert _rel(kern.grid.mean_energy_j, scan.grid.mean_energy_j) <= 1e-4
    for p in (0, len(table) - 1):
        st = S.renewal_monte_carlo_device(
            SC.apply_policy(cfg, **table.policy(p)), prng.PRNGKey(2),
            n_runs=256, max_failures=32, makespan_s=float(scan.grid.makespan_s[p]),
            mtbf_s=MTBF_S, stats=True, device="cuda")
        np.testing.assert_array_equal(to_np(st.energy_int[0]),
                                      scan.grid.energy_int[p])
