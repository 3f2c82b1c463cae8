"""PyTorch port: correlated rack failures (``core/topology.py``) and the
``topology=`` axis of the renewal engines, against the reference.

Fixtures are the reference's own (tests/test_topology.py): key 3, 7 d
MTBF, Weibull k = 0.7, a gentle rack topology (racks of 3, 8 d shocks,
p_kill 0.6, 1800 s age boost) and an aggressive one (one rack of every
node, 3 d shocks, p_kill 0.95, 3600 s boost) that makes multi-felled AND
all-felled epochs common.  Bars:

* the three uniform streams (``split(key, 3)``: residual, shock, kill) are
  ``jax.random``'s bit for bit;
* felled masks and primaries equal; gaps within 2 ulp with exponential
  marginals (a 1-ulp ``log1p``); with Weibull marginals within 1e-5 of
  ``gap +`` the oldest clock's age (the backends' ``pow`` differ by ulps,
  and each backend carries its own ages);
* Monte-Carlo summaries on the six Table-4 scenarios: per-node failure
  counts equal, mean energies and saving within 1e-4, on the port's
  ``"host"`` and ``"device"`` engines against the reference's host oracle;
* ``simulate_run(topology=)`` and the event simulator against
  ``renewal_compose`` on multi-felled epochs within 1e-4, as the
  reference's test does;
* the trace tools (host numpy) equal to the reference's, the LANL CSV text
  and ``burst_replay_gaps`` bit for bit.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, to_np

from repro_torch.core import failures as F
from repro_torch.core import optimize, prng, scenarios, simulator, sweep
from repro_torch.core import topology as T

MTBF = 7 * 24 * 3600.0
MAKESPAN = 30 * 24 * 3600.0
KEY = 3


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def gentle(mod, n):
    return mod.rack_topology(n, 3, shock_mtbs_s=8 * 24 * 3600.0, p_kill=0.6,
                             age_boost_s=1800.0)


def aggressive(mod, n):
    return mod.rack_topology(n, n, shock_mtbs_s=3 * 24 * 3600.0, p_kill=0.95,
                             age_boost_s=3600.0)


TOPOLOGIES = {"gentle": gentle, "aggressive": aggressive}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


class _Recording(F.FailureProcess):
    """Forwards to a process and keeps the clock ages the sampler asked at."""

    def __init__(self, proc):
        self.proc, self.ages = proc, []

    def residual(self, v, age):
        self.ages.append(age.clone())
        return self.proc.residual(v, age)


def test_uniform_streams_bit_exact(ref):
    jr, jnp = ref.jax.random, ref.jax.numpy
    ours = prng.split(prng.PRNGKey(KEY), 3)
    theirs = np.asarray(jr.split(jr.PRNGKey(KEY), 3))
    np.testing.assert_array_equal(ours, theirs)
    for k_t, k_j, g in zip(ours, theirs, (4, 2, 4)):
        u_t = to_np(prng.uniform(k_t, (12, 32, g), device="cpu"))
        u_j = np.asarray(jr.uniform(k_j, (12, 32, g), jnp.float32))
        np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))


@pytest.mark.parametrize("topo", ["gentle", "aggressive"])
@pytest.mark.parametrize("family", ["exponential", "weibull"])
def test_correlated_sampler_matches_reference(ref, topo, family):
    n = 4
    if family == "exponential":
        p_t, p_j = F.Exponential(MTBF), ref.failures.Exponential(MTBF)
    else:
        p_t = F.Weibull.from_mtbf(0.7, MTBF)
        p_j = ref.failures.Weibull.from_mtbf(0.7, MTBF)
    rec = _Recording(p_t)
    g_t, m_t, pr_t = T.sample_correlated_renewal_gaps(
        TOPOLOGIES[topo](T, n), rec, prng.PRNGKey(KEY), 32, 12, n,
        device="cpu")
    assert (g_t.dtype, m_t.dtype, pr_t.dtype) == \
        (torch.float32, torch.bool, torch.int32)
    assert tuple(m_t.shape) == (32, 12, n)
    g_j, m_j, pr_j = (np.asarray(a) for a in ref.topology.sample_correlated_renewal_gaps(
        TOPOLOGIES[topo](ref.topology, n), p_j, ref.jax.random.PRNGKey(KEY),
        32, 12, n))
    np.testing.assert_array_equal(to_np(m_t), m_j)
    np.testing.assert_array_equal(to_np(pr_t), pr_j)
    if family == "exponential":
        assert _ulps(to_np(g_t), g_j).max() <= 2
    else:
        oldest = to_np(torch.stack(rec.ages, dim=1)).max(axis=-1)   # (R, K)
        err = np.abs(to_np(g_t).astype(np.float64) - g_j)
        assert np.all(err <= 1e-5 * (g_j + oldest))
    # shocks present; the aggressive fixture fells every node at times
    n_felled = m_j.sum(-1)
    assert int((n_felled > 1).sum()) > 0
    if topo == "aggressive":
        assert int((n_felled == n).sum()) > 0
    # the primary is one of the felled nodes
    assert np.all(np.take_along_axis(m_j, pr_j[..., None].astype(np.int64),
                                     -1))


def test_host_entry_point_and_renewal_failure_gaps(ref):
    n = 4
    proc = F.Weibull.from_mtbf(0.7, MTBF)
    topo = gentle(T, n)
    g, m, pr = T.correlated_renewal_gaps(topo, proc, prng.PRNGKey(KEY), 16, n,
                                         9, device="cpu")
    assert (g.dtype, m.dtype, pr.dtype) == (np.float64, bool, np.int64)
    gaps, primary, fmask = sweep.renewal_failure_gaps(
        prng.PRNGKey(KEY), 16, n, 9, process=proc, topology=topo,
        device="cpu")
    np.testing.assert_array_equal(to_np(gaps), g)
    np.testing.assert_array_equal(to_np(primary), pr)
    np.testing.assert_array_equal(to_np(fmask), m)
    with pytest.raises(ValueError):
        T.sample_correlated_renewal_gaps(topo, proc, prng.PRNGKey(0), 2, 2, 5,
                                         device="cpu")


def test_survivor_slot_mask_numpy_and_torch(ref):
    rng = np.random.default_rng(0)
    fmask = rng.random((5, 7, 4)) < 0.5
    primary = rng.integers(0, 4, (5, 7))
    want = np.asarray(ref.topology.survivor_slot_mask(fmask, primary))
    np.testing.assert_array_equal(T.survivor_slot_mask(fmask, primary), want)
    got = T.survivor_slot_mask(torch.from_numpy(fmask),
                               torch.from_numpy(primary).to(torch.int32))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(to_np(got), want)


def test_topology_validation_matches_reference(ref):
    for mod in (T, ref.topology):
        with pytest.raises(ValueError):
            mod.TopologyLevel("rack", (0, 2), shock_mtbs_s=1.0)     # gap in ids
        with pytest.raises(ValueError):
            mod.TopologyLevel("rack", (0, 1), shock_mtbs_s=1.0, p_kill=0.0)
        with pytest.raises(ValueError):
            mod.TopologyLevel("rack", (0, 1), shock_mtbs_s=1.0, age_boost_s=-1.0)
        with pytest.raises(ValueError):
            mod.TopologyLevel("rack", (0, 1), shock_mtbs_s=-5.0)
        with pytest.raises(ValueError):
            mod.Topology(n_nodes=3, levels=(
                mod.TopologyLevel("rack", (0, 1), shock_mtbs_s=1.0),))
        with pytest.raises(ValueError):
            mod.rack_topology(4, 0, shock_mtbs_s=1.0)
    two = lambda mod: mod.Topology(n_nodes=4, levels=(
        mod.TopologyLevel("psu", (0, 0, 1, 1), shock_mtbs_s=[5e5, 6e5],
                          p_kill=0.8),
        mod.TopologyLevel("room", (0, 0, 0, 0), shock_mtbs_s=2e6)))
    assert two(T).label() == two(ref.topology).label()
    np.testing.assert_array_equal(T._member_matrix(two(T)),
                                  ref.topology._member_matrix(two(ref.topology)))
    for a, b in zip(T._group_params(two(T)),
                    ref.topology._group_params(two(ref.topology))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_two_level_topology_histories(ref):
    """A PSU level under a room level: several shock clocks per epoch."""
    mk = lambda mod: mod.Topology(n_nodes=4, levels=(
        mod.TopologyLevel("psu", (0, 0, 1, 1), shock_mtbs_s=[5e5, 6e5],
                          p_kill=0.8, age_boost_s=600.0),
        mod.TopologyLevel("room", (0, 0, 0, 0), shock_mtbs_s=2e6,
                          p_kill=0.5)))
    proc_t, proc_j = F.Exponential(MTBF), ref.failures.Exponential(MTBF)
    g_t, m_t, p_t = T.correlated_renewal_gaps(mk(T), proc_t, prng.PRNGKey(1),
                                              64, 4, 10, device="cpu")
    g_j, m_j, p_j = ref.topology.correlated_renewal_gaps(
        mk(ref.topology), proc_j, ref.jax.random.PRNGKey(1), 64, 4, 10)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(p_t, p_j)
    assert _ulps(g_t, g_j).max() <= 2


@pytest.mark.parametrize("name", list(scenarios.paper_scenarios()))
def test_correlated_summaries_all_scenarios(ref, name):
    cfg = scenarios.paper_scenarios()[name]
    n = len(cfg.survivors) + 1
    proc = F.Weibull.from_mtbf(0.7, MTBF)
    kw = dict(n_runs=32, max_failures=12)
    theirs = ref.sweep.renewal_monte_carlo(
        ref.scenarios.paper_scenarios()[name], ref.jax.random.PRNGKey(KEY),
        engine="host", process=ref.failures.Weibull.from_mtbf(0.7, MTBF),
        topology=aggressive(ref.topology, n), **kw)
    for engine in ("host", "device"):
        ours = sweep.renewal_monte_carlo(
            cfg, prng.PRNGKey(KEY), engine=engine, process=proc,
            topology=aggressive(T, n), device="cpu", **kw)
        assert ours.per_node_failures == theirs.per_node_failures, engine
        assert ours.mean_failures == theirs.mean_failures, engine
        for f in ("mean_energy_ref_j", "mean_energy_int_j"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert abs(a - b) <= 1e-4 * abs(b), (engine, f)
        assert abs(ours.mean_saving_j - theirs.mean_saving_j) \
            <= 1e-4 * theirs.mean_energy_ref_j


def test_correlated_engines_agree_within_the_port():
    """Scan, kernel (plain version) and host oracle on one correlated key:
    every count equal, the scan within 1e-9 and the kernel within 1e-4 of
    the oracle; every felled node counts in per_node_failures."""
    cfgs = list(scenarios.paper_scenarios().values())
    n = len(cfgs[0].survivors) + 1
    proc = F.Weibull.from_mtbf(0.7, MTBF)
    topo = aggressive(T, n)
    kw = dict(n_runs=24, max_failures=10, process=proc, topology=topo,
              device="cpu")
    scan = sweep.renewal_monte_carlo_scenarios(cfgs, prng.PRNGKey(5), **kw)
    kern = sweep.renewal_monte_carlo_scenarios(cfgs, prng.PRNGKey(5),
                                               engine="kernel", **kw)
    for cfg in cfgs:
        host = sweep.renewal_monte_carlo(cfg, prng.PRNGKey(5), engine="host",
                                         **kw)
        for s, tol in ((scan[cfg.name], 1e-9), (kern[cfg.name], 1e-4)):
            for f in ("per_node_failures", "failure_count_hist",
                      "sleep_occupancy", "min_freq_rate", "comp_change_rate",
                      "infeasible_rate", "truncated_rate"):
                assert getattr(s, f) == getattr(host, f), (cfg.name, f)
            for f in ("mean_energy_ref_j", "mean_energy_int_j"):
                assert abs(getattr(s, f) / getattr(host, f) - 1) <= tol
        # per-node counts are felled nodes, more than one per epoch
        assert sum(host.per_node_failures) > host.mean_failures


def test_simulator_cross_validates_multi_felled_epochs():
    """The event simulator on correlated histories against the analytic
    renewal_compose, per epoch and per node (the reference's test)."""
    proc = F.Weibull.from_mtbf(0.7, MTBF)
    n_multi = n_all = 0
    for name, cfg in scenarios.paper_scenarios().items():
        n_nodes = len(cfg.survivors) + 1
        topo = aggressive(T, n_nodes)
        gaps, primary, fmask = sweep.renewal_failure_gaps(
            prng.PRNGKey(9), 4, n_nodes, 12, process=proc, topology=topo,
            device="cpu")
        felled = T.survivor_slot_mask(fmask, primary)
        res = sweep.renewal_compose(cfg, gaps, MAKESPAN, failed_node=primary,
                                    felled=felled, device="cpu")
        for r in range(4):
            run = simulator.simulate_run(cfg, to_np(gaps[r]), MAKESPAN,
                                         felled=to_np(felled[r]), device="cpu")
            for e in run.epochs:
                k = e.index
                if e.felled is not None and e.felled.any():
                    n_multi += 1
                    n_all += int(e.felled.sum() == n_nodes - 1)
                for fld, oracle in (("energy_ref", res.epoch_ref),
                                    ("energy_int", res.epoch_int)):
                    a = getattr(e, fld)
                    b = to_np(oracle)[r, k]
                    rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))
                    assert rel < 1e-4, (name, r, k, fld)
                bf = float(res.epoch_failed[r, k])
                assert abs(e.energy_failed - bf) <= 1e-4 * max(abs(bf), 1.0)
            for fld in ("energy_ref", "energy_int", "saving"):
                a, b = getattr(run, fld), float(getattr(res, fld)[r])
                assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (name, r, fld)
            assert run.n_failures == int(res.valid[r].sum())
    assert n_multi > 10
    assert n_all > 0


def test_simulate_run_topology_sampling_path(ref):
    cfg = scenarios.paper_scenarios()["scenario2_long_reexec"]
    n = len(cfg.survivors) + 1
    proc = F.Weibull.from_mtbf(0.7, MTBF)
    run = simulator.simulate_run(cfg, None, MAKESPAN, process=proc,
                                 key=prng.PRNGKey(KEY),
                                 topology=aggressive(T, n), max_failures=12,
                                 device="cpu")
    theirs = ref.simulator.simulate_run(
        ref.scenarios.paper_scenarios()["scenario2_long_reexec"], None,
        MAKESPAN, process=ref.failures.Weibull.from_mtbf(0.7, MTBF),
        key=ref.jax.random.PRNGKey(KEY), topology=aggressive(ref.topology, n),
        max_failures=12)
    assert run.n_failures == theirs.n_failures > 0
    for fld in ("energy_ref", "energy_int", "saving"):
        assert abs(getattr(run, fld) / getattr(theirs, fld) - 1) <= 1e-4
    with pytest.raises(ValueError):
        simulator.simulate_run(cfg, np.full(4, 1e5), MAKESPAN,
                               topology=aggressive(T, n), device="cpu")


def test_policy_grid_under_topology_keeps_crn(ref):
    """Every policy lane meets the same correlated histories: a lane equals
    a standalone one-policy call bit for bit, and the grid's means are the
    reference's within 1e-4."""
    cfg = scenarios.sparse_rendezvous_scenario()
    n = len(cfg.survivors) + 1
    topo = gentle(T, n)
    table = optimize.policy_grid(ckpt_interval=[3600.0, 7200.0],
                                 mu1=[4.0, 8.0])
    kw = dict(work_s=2e5, n_runs=16, max_failures=6, mtbf_s=5e4,
              topology=topo, device="cpu")
    grid = optimize.evaluate_policy_grid(cfg, table, prng.PRNGKey(2), **kw)
    for p in range(len(table)):
        one = optimize.evaluate_policy_grid(
            cfg, optimize.policy_grid(**{k: [v] for k, v in
                                         table.policy(p).items()}),
            prng.PRNGKey(2), **kw)
        np.testing.assert_array_equal(grid.energy_int[p], one.energy_int[0])
        np.testing.assert_array_equal(grid.end_time[p], one.end_time[0])
    rcfg = ref.scenarios.sparse_rendezvous_scenario()
    theirs = ref.optimize.evaluate_policy_grid(
        rcfg, ref.optimize.policy_grid(ckpt_interval=[3600.0, 7200.0],
                                       mu1=[4.0, 8.0]),
        ref.jax.random.PRNGKey(2), work_s=2e5, n_runs=16, max_failures=6,
        mtbf_s=5e4, topology=gentle(ref.topology, n))
    np.testing.assert_allclose(grid.mean_energy_j, theirs.mean_energy_j,
                               rtol=1e-4)
    np.testing.assert_array_equal(grid.n_failures, theirs.n_failures)
    kern = optimize.evaluate_policy_grid(cfg, table, prng.PRNGKey(2),
                                         engine="kernel", **kw)
    np.testing.assert_array_equal(kern.n_failures, grid.n_failures)
    np.testing.assert_allclose(kern.mean_energy_j, grid.mean_energy_j,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# trace ingestion (host numpy)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic(ref):
    """A correlated history flattened to a trace, by both packages, on the
    reference's sampled history (so the tools see the same input)."""
    topo_j = ref.topology.rack_topology(8, 2, shock_mtbs_s=10 * 24 * 3600.0,
                                        p_kill=0.9)
    gaps, fmask, _ = ref.topology.correlated_renewal_gaps(
        topo_j, ref.failures.Exponential(MTBF), ref.jax.random.PRNGKey(1),
        n_runs=1, n_nodes=8, max_failures=400)
    log_j = ref.topology.history_to_log(gaps, fmask, downtime_s=600.0)
    log_t = T.history_to_log(gaps, torch.from_numpy(np.array(fmask)),
                             downtime_s=600.0)
    topo_t = T.rack_topology(8, 2, shock_mtbs_s=10 * 24 * 3600.0, p_kill=0.9)
    return log_t, log_j, topo_t, topo_j


def _logs_equal(a, b):
    np.testing.assert_array_equal(a.node, b.node)
    np.testing.assert_array_equal(a.t_s, b.t_s)
    np.testing.assert_array_equal(a.downtime_s, b.downtime_s)
    assert a.n_nodes == b.n_nodes


def test_history_to_log_and_lanl_round_trip(ref, synthetic):
    log_t, log_j, _, _ = synthetic
    _logs_equal(log_t, log_j)
    csv = T.to_lanl_csv(log_t)
    assert csv == ref.topology.to_lanl_csv(log_j)
    _logs_equal(T.parse_lanl_csv(csv, n_nodes=8),
                ref.topology.parse_lanl_csv(csv, n_nodes=8))
    lines = ["# comment", "node,timestamp,downtime", "3,10.5,60", "", "1,2.0,5"]
    _logs_equal(T.parse_lanl_csv(lines), ref.topology.parse_lanl_csv(lines))
    for bad in (["1,2"], ["0,1,1", "x,2,2"]):
        with pytest.raises(ValueError):
            T.parse_lanl_csv(bad)
    assert len(log_t) == len(log_j) and log_t.span_s == log_j.span_s


def test_bursts_rates_and_marginals(ref, synthetic):
    log_t, log_j, topo_t, topo_j = synthetic
    assert T.find_bursts(log_t, 1.0) == ref.topology.find_bursts(log_j, 1.0)
    fit_t = T.fit_shock_rates(log_t, topo_t, burst_window_s=1.0)
    fit_j = ref.topology.fit_shock_rates(log_j, topo_j, burst_window_s=1.0)
    assert fit_t == fit_j
    assert fit_t["rack"]["n_bursts"] > 10
    emp_t, emp_j = T.trace_to_empirical(log_t), ref.topology.trace_to_empirical(log_j)
    np.testing.assert_array_equal(emp_t.gaps, np.asarray(emp_j.gaps))
    times = log_t.t_s
    for kw in ({}, {"span_s": float(times[-1] - times[0]) * 2, "n_windows": 16}):
        assert T.dispersion_index(times, **kw) == \
            ref.topology.dispersion_index(times, **kw)


def test_burst_replay_bit_equal(ref, synthetic):
    log_t, log_j, _, _ = synthetic
    ours = T.burst_replay_gaps(log_t, prng.PRNGKey(KEY), 4, 16,
                               burst_window_s=1.0)
    theirs = ref.topology.burst_replay_gaps(
        log_j, ref.jax.random.PRNGKey(KEY), 4, 16, burst_window_s=1.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    gaps, mask, primary = ours
    assert gaps.shape == (4, 16) and np.all(gaps > 0)
    assert float(mask.sum(-1).mean()) > 1.05
    assert np.all(np.take_along_axis(mask, primary[..., None], -1))
