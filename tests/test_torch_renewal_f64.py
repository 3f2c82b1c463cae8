"""PyTorch port: the float64 scan renewal engine (``engine="scan"``).

  * ``renewal_compose_device`` against the port's float64 host oracle
    ``renewal_compose`` and against the reference's scan, with and without
    felled survivors: integer fields exact, energies within 1e-9 relative
    (observed: 0 against the port's oracle, ~3e-10 against the reference,
    whose float32 Algorithm-1 values differ from the port's by an ulp);
  * ``stats=True`` against ``stats=False``;
  * epoch 0 equal to the single-failure sweep (tests/test_renewal_device.py);
  * a gap exactly on the makespan occurs, one ulp past it does not;
    truncation;
  * the policy lane equal to a standalone call (common random numbers);
  * the scan's means against ``engine="kernel"`` (its plain path here);
  * the default engines: a default call of the port and of the reference on
    the same key agree to 1e-9 on mean energies, counts exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda, to_np

from repro_torch.core import optimize as O
from repro_torch.core import prng
from repro_torch.core import scenarios as SC
from repro_torch.core import simulator as SIM
from repro_torch.core import sweep as S

TOL = 1e-9
MAKESPAN = 30 * 24 * 3600.0
SUMMARY_EXACT = ("n_runs", "max_failures", "mean_failures",
                 "failure_count_hist", "per_node_failures", "truncated_rate",
                 "sleep_occupancy", "min_freq_rate", "comp_change_rate",
                 "infeasible_rate")
GRID = dict(ckpt_interval=np.geomspace(2400.0, 19200.0, 7)[1::2],
            mu1=[3.8, 9.0], wait_mode=[0, 1])
GRID_KW = dict(work_s=2 * 24 * 3600.0, n_runs=48, max_failures=24,
               mtbf_s=8 * 3600.0)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def histories(ref):
    """The reference's sampled histories, plus a felled mask."""
    gaps, failed = ref.sweep.renewal_failure_gaps(
        ref.jax.random.PRNGKey(2), 24, 4, 10, 5 * 24 * 3600.0)
    felled = np.random.default_rng(3).random((24, 10, 3)) < 0.15
    return gaps, failed, felled


def _rel(a, b):
    a, b = np.asarray(to_np(a), np.float64), np.asarray(to_np(b), np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("with_felled", [False, True])
def test_compose_device_matches_both_host_oracles(ref, histories, with_felled):
    gaps, failed, felled = histories
    felled = felled if with_felled else None
    cfgs = list(SC.paper_scenarios().values())
    ours = S.renewal_compose_device(cfgs, gaps, MAKESPAN, failed_node=failed,
                                    felled=felled, device="cpu")
    theirs = ref.sweep.renewal_compose_device(
        list(ref.scenarios.paper_scenarios().values()), gaps, MAKESPAN,
        failed_node=failed, felled=felled)
    worst = {"port oracle": 0.0, "reference": 0.0}
    for s, cfg in enumerate(cfgs):
        host = S.renewal_compose(cfg, gaps, MAKESPAN, failed_node=failed,
                                 felled=felled, device="cpu")
        for f in ("valid", "n_failures", "truncated", "failed_node"):
            np.testing.assert_array_equal(to_np(getattr(ours, f)[s]),
                                          to_np(getattr(host, f)), err_msg=f)
            np.testing.assert_array_equal(to_np(getattr(ours, f)[s]),
                                          np.asarray(getattr(theirs, f))[s],
                                          err_msg=f)
        k = to_np(host.valid)
        for f in ("level", "wait_action", "comp_changed", "feasible_any"):
            mine = to_np(getattr(ours.decision, f)[s])[k]
            assert np.array_equal(mine, to_np(getattr(host.decision, f))[k]), f
            assert np.array_equal(mine, np.asarray(getattr(theirs.decision, f))[s][k]), f
        for f in ("energy_ref", "energy_int", "balanced_energy", "end_time",
                  "t_fail", "t_renewal", "epoch_failed"):
            worst["port oracle"] = max(worst["port oracle"],
                                       _rel(getattr(ours, f)[s], getattr(host, f)))
            worst["reference"] = max(worst["reference"], _rel(
                getattr(ours, f)[s], np.asarray(getattr(theirs, f))[s]))
        for other in (to_np(host.saving), np.asarray(theirs.saving)[s]):
            assert np.all(np.abs(to_np(ours.saving[s]) - other)
                          <= TOL * to_np(host.energy_ref))
    assert worst["port oracle"] <= TOL and worst["reference"] <= TOL, worst
    if with_felled:
        assert bool(np.any(felled & to_np(ours.valid[0])[..., None]))


def test_stats_mode_equals_full_mode():
    cfgs = list(SC.paper_scenarios().values())
    kw = dict(n_runs=32, max_failures=12, makespan_s=10 * 24 * 3600.0,
              mtbf_s=2 * 24 * 3600.0, device="cpu")
    stats = S.renewal_monte_carlo_device(cfgs, prng.PRNGKey(4), stats=True, **kw)
    full = S.renewal_monte_carlo_device(cfgs, prng.PRNGKey(4), **kw)
    assert isinstance(full, S.RenewalDeviceResult)
    for f in ("n_failures", "truncated", "end_time", "balanced_energy",
              "energy_ref", "energy_int", "saving"):
        assert torch.equal(getattr(stats, f), getattr(full, f)), f
    v = full.valid[..., None].expand(full.decision.level.shape)
    d = full.decision
    for f, mask in (("n_points", torch.ones_like(v)),
                    ("n_sleep", d.wait_action == 2),
                    ("n_min_freq", d.wait_action == 1),
                    ("n_comp_changed", d.comp_changed),
                    ("n_infeasible", ~d.feasible_any)):
        assert torch.equal(getattr(stats, f).long(), (v & mask).sum(dim=(2, 3))), f
    node = torch.arange(4)
    hits = (full.failed_node[..., None] == node) & full.valid[..., None]
    assert torch.equal(stats.failed_counts.long(), hits.sum(dim=(1, 2)))
    assert int(full.n_failures.max()) == 12 and bool(stats.truncated.any())


def test_first_epoch_equals_single_failure_sweep():
    cfg = SC.paper_scenarios()["scenario2_long_reexec"]
    delta = 4321.0
    res = S.renewal_compose_device(cfg, np.array([delta, 1e9]), 1e7, device="cpu")
    single = S.sweep_failure_times(cfg, np.array([delta]), device="cpu")
    assert torch.equal(res.decision.level[0, 0, 0], single.decision.level[0])
    torch.testing.assert_close(res.decision.saving[0, 0, 0],
                               single.decision.saving[0], rtol=1e-6, atol=0.0)


def test_gap_on_makespan_and_truncation():
    """As tests/test_renewal_device.py: a gap consuming exactly the
    remaining makespan occurs (and the run is complete, not truncated); a
    gap one ulp past it is dropped; runs that use every gap with balanced
    time left are truncated, runs killed by an overlong gap are not."""
    cfg = SC.paper_scenarios()["scenario4_short_active_waits"]
    makespan = 20000.0
    on = np.array([[makespan, 1.0]])
    dev_on = S.renewal_compose_device(cfg, on, makespan, device="cpu")
    host_on = S.renewal_compose(cfg, on, makespan, device="cpu")
    run_on = SIM.simulate_run(cfg, on[0], makespan, device="cpu")
    assert int(dev_on.n_failures[0, 0]) == run_on.n_failures == 1
    assert not bool(dev_on.truncated[0, 0])
    assert _rel(dev_on.energy_ref[0, 0], host_on.energy_ref[0]) <= TOL
    assert _rel(dev_on.energy_ref[0, 0], run_on.energy_ref) <= 1e-6
    past = np.array([[np.nextafter(makespan, np.inf), 1.0]])
    dev_past = S.renewal_compose_device(cfg, past, makespan, device="cpu")
    assert int(dev_past.n_failures[0, 0]) == 0
    assert not bool(dev_past.truncated[0, 0])

    gaps = np.array([[2000.0, 3000.0], [2000.0, 1e9], [1e9, 100.0]])
    dev = S.renewal_compose_device(cfg, gaps, 60000.0, device="cpu")
    host = S.renewal_compose(cfg, gaps, 60000.0, device="cpu")
    assert dev.n_failures[0].tolist() == [2, 1, 0]
    assert dev.truncated[0].tolist() == [True, False, False]
    assert torch.equal(dev.valid[0], host.valid)
    assert _rel(dev.energy_ref[0], host.energy_ref) <= TOL


@pytest.fixture(scope="module")
def scan_grid():
    return O.evaluate_policy_grid(SC.sparse_rendezvous_scenario(),
                                  O.policy_grid(**GRID), prng.PRNGKey(3),
                                  device="cpu", **GRID_KW)


def test_policy_lane_equals_standalone_call(scan_grid):
    """Common random numbers on the scan: a grid lane is bit-identical to a
    standalone call of that policy alone (sums are fixed trees, so a lane's
    bits do not depend on the lanes beside it)."""
    cfg = SC.sparse_rendezvous_scenario()
    for p in range(len(scan_grid.table)):
        cfg_p = SC.apply_policy(cfg, **scan_grid.table.policy(p))
        st = S.renewal_monte_carlo_device(
            cfg_p, prng.PRNGKey(3), n_runs=GRID_KW["n_runs"],
            max_failures=GRID_KW["max_failures"],
            makespan_s=float(scan_grid.makespan_s[p]),
            mtbf_s=GRID_KW["mtbf_s"], stats=True, device="cpu")
        np.testing.assert_array_equal(to_np(st.energy_int[0]),
                                      scan_grid.energy_int[p])
        np.testing.assert_array_equal(to_np(st.end_time[0]), scan_grid.end_time[p])
        np.testing.assert_array_equal(to_np(st.n_failures[0]),
                                      scan_grid.n_failures[p])


def test_compose_policies_matches_per_policy_scenarios():
    cfg = SC.sparse_rendezvous_scenario()
    table = O.policy_grid(**GRID)
    makespans = O.wall_makespan(GRID_KW["work_s"], table.ckpt_interval,
                                cfg.ckpt_duration)
    gaps = np.random.default_rng(8).exponential(9000.0, (6, 20))
    res = S.renewal_compose_policies(O.policy_inputs(cfg, table, "cpu"), gaps,
                                     makespans)
    for p in (0, 5, len(table) - 1):
        one = S.renewal_compose_device(SC.apply_policy(cfg, **table.policy(p)),
                                       gaps, float(makespans[p]), device="cpu")
        for f in ("energy_ref", "energy_int", "end_time", "valid", "epoch_int"):
            assert torch.equal(getattr(res, f)[p], getattr(one, f)[0]), f


def test_scan_means_match_the_kernel_engine():
    """The scan against ``engine="kernel"`` (the plain version of the CUDA
    kernel on the CPU) on the same histories: means within 1e-4 (the
    reference's bar between its scan and pallas engines), counts exact."""
    cfgs = list(SC.paper_scenarios().values())
    kw = dict(n_runs=96, max_failures=24, device="cpu")
    scan = S.renewal_monte_carlo_scenarios(cfgs, prng.PRNGKey(6), **kw)
    kern = S.renewal_monte_carlo_scenarios(cfgs, prng.PRNGKey(6),
                                           engine="kernel", **kw)
    for name, a in scan.items():
        b = kern[name]
        for f in SUMMARY_EXACT:
            assert getattr(a, f) == getattr(b, f), (name, f)
        for f in ("mean_energy_ref_j", "mean_energy_int_j"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-4)


def test_default_engines_match_reference(ref, scan_grid):
    """With default engines the port and the reference both run the float64
    scan: the same summaries on the same key (each side samples its own
    histories; gaps agree within a few ulp)."""
    cfgs_t = list(SC.paper_scenarios().values())
    cfgs_j = list(ref.scenarios.paper_scenarios().values())
    kw = dict(n_runs=48, max_failures=16)
    key_t, key_j = prng.PRNGKey(1), ref.jax.random.PRNGKey(1)
    ours = S.renewal_monte_carlo_scenarios(cfgs_t, key_t, device="cpu", **kw)
    theirs = ref.sweep.renewal_monte_carlo_scenarios(cfgs_j, key_j, **kw)
    one_t = S.renewal_monte_carlo(cfgs_t[3], key_t, device="cpu", **kw)
    one_j = ref.sweep.renewal_monte_carlo(cfgs_j[3], key_j, **kw)
    pairs = [(ours[n], theirs[n]) for n in theirs] + [(one_t, one_j)]
    for a, b in pairs:
        for f in SUMMARY_EXACT:
            assert getattr(a, f) == getattr(b, f), f
        for f in ("mean_energy_ref_j", "mean_energy_int_j"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=TOL), f
    assert one_t == ours[cfgs_t[3].name]
    # the per-epoch view is the default of renewal_monte_carlo_device
    full_t = S.renewal_monte_carlo_device(cfgs_t[:2], key_t, device="cpu", **kw)
    full_j = ref.sweep.renewal_monte_carlo_device(cfgs_j[:2], key_j, **kw)
    assert isinstance(full_t, S.RenewalDeviceResult)
    np.testing.assert_array_equal(to_np(full_t.valid), np.asarray(full_j.valid))
    assert _rel(full_t.energy_int.mean(dim=1),
                np.asarray(full_j.energy_int).mean(axis=1)) <= TOL
    # the policy grid
    theirs_grid = ref.optimize.evaluate_policy_grid(
        ref.scenarios.sparse_rendezvous_scenario(),
        ref.optimize.policy_grid(**GRID), ref.jax.random.PRNGKey(3), **GRID_KW)
    assert scan_grid.best == theirs_grid.best
    np.testing.assert_array_equal(scan_grid.n_failures, theirs_grid.n_failures)
    assert _rel(scan_grid.mean_energy_j, theirs_grid.mean_energy_j) <= TOL
    assert _rel(scan_grid.mean_makespan_s, theirs_grid.mean_makespan_s) <= TOL


def test_scan_inputs_validated_like_host():
    cfgs = SC.paper_scenarios()
    slowed = cfgs["scenario4_short_active_waits"]
    slowed = dataclasses.replace(slowed, survivors=tuple(
        dataclasses.replace(sv, level=1) for sv in slowed.survivors))
    with pytest.raises(ValueError, match="balanced"):
        S.renewal_compose_device(slowed, [5000.0], 6e4, device="cpu")
    with pytest.raises(ValueError, match="no scenarios"):
        S.renewal_compose_device([], [5000.0], 6e4, device="cpu")
    with pytest.raises(ValueError, match="stats-only"):
        S.renewal_monte_carlo_device(cfgs["scenario1_short_reexec"],
                                     prng.PRNGKey(0), engine="kernel",
                                     device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        S.renewal_monte_carlo_device(cfgs["scenario1_short_reexec"],
                                     prng.PRNGKey(0), engine="pallas",
                                     device="cpu")


@requires_cuda
def test_scan_on_card_matches_cpu_bit_for_bit():
    skip_without_cuda()
    rng = np.random.default_rng(5)
    gaps = rng.exponential(1.5 * 24 * 3600.0, (64, 16))
    failed = rng.integers(0, 4, (64, 16))
    felled = rng.random((64, 16, 3)) < 0.15
    cfgs = list(SC.paper_scenarios().values())
    card = S.renewal_compose_device(cfgs, gaps, MAKESPAN, failed_node=failed,
                                    felled=felled, device="cuda")
    cpu = S.renewal_compose_device(cfgs, gaps, MAKESPAN, failed_node=failed,
                                   felled=felled, device="cpu")
    for f in dataclasses.fields(card):
        if f.name == "decision":
            for g in dataclasses.fields(card.decision):
                assert torch.equal(getattr(card.decision, g.name).cpu(),
                                   getattr(cpu.decision, g.name)), g.name
        else:
            assert torch.equal(getattr(card, f.name).cpu(),
                               getattr(cpu, f.name)), f.name
