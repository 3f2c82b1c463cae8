"""PyTorch port: the renewal Monte-Carlo slice against the reference.

  * the float64 host oracle ``renewal_compose`` against the reference's,
    within 1e-9 relative on whole-run energies, integer fields exact;
  * the slice as a whole: ``renewal_monte_carlo_scenarios(engine="kernel",
    device="cpu")`` against the reference's ``engine="pallas"`` and its host
    oracle (mean whole-run energies within 1e-4, integer means exact), and
    the policy grid on ``engine="kernel"`` (argmin and knee equal, mean
    energies within 1e-4).  The default engine, the float64 scan, is held
    by tests/test_torch_renewal_f64.py.

The port samples its own histories (bit-exact uniforms; ``log1p``/``pow``
within a few ulp, see test_torch_prng_failures.py), so per-run energies are
compared where both sides get the same gaps (the oracle tests) and the
Monte-Carlo summaries where each side samples its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, to_np

from repro_torch.core import failures as F
from repro_torch.core import optimize as O
from repro_torch.core import prng
from repro_torch.core import scenarios as SC
from repro_torch.core import sweep as S
from repro_torch.kernels import renewal_scan as rs

GAPS = np.array([5000.0, 9000.0, 4000.0, 2500.0])
MAKESPAN = 60000.0
MC = dict(n_runs=64, max_failures=16)
# the odd points of the 42-policy grid's geomspace(2400, 19200, 7): intervals
# incommensurate with the 14400 s rendezvous period (for the commensurate
# ones see test_commensurate_interval_against_oracle)
GRID = dict(ckpt_interval=np.geomspace(2400.0, 19200.0, 7)[1::2],
            mu1=[3.8, 9.0], wait_mode=[0, 1])
GRID_KW = dict(work_s=2 * 24 * 3600.0, n_runs=48, max_failures=24,
               mtbf_s=8 * 3600.0)
SUMMARY_EXACT = ("n_runs", "max_failures", "mean_failures",
                 "failure_count_hist", "per_node_failures", "truncated_rate",
                 "sleep_occupancy", "min_freq_rate", "comp_change_rate",
                 "infeasible_rate")
SUMMARY_ENERGY = ("mean_energy_ref_j", "mean_energy_int_j")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _energies_close(ours, theirs, rtol):
    for f in ("energy_ref", "energy_int", "balanced_energy", "end_time"):
        np.testing.assert_allclose(to_np(getattr(ours, f)),
                                   np.asarray(getattr(theirs, f)), rtol=rtol,
                                   err_msg=f)
    sav = np.abs(to_np(ours.saving) - np.asarray(theirs.saving))
    assert np.all(sav <= rtol * np.asarray(theirs.energy_ref))


@pytest.mark.parametrize("name", sorted(SC.paper_scenarios()))
def test_host_oracle_matches_reference(ref, name):
    ours = S.renewal_compose(SC.paper_scenarios()[name], GAPS, MAKESPAN,
                             device="cpu")
    theirs = ref.sweep.renewal_compose(ref.scenarios.paper_scenarios()[name],
                                       GAPS, MAKESPAN)
    _energies_close(ours, theirs, 1e-9)
    for f in ("valid", "n_failures", "truncated", "failed_node", "n_ckpt"):
        np.testing.assert_array_equal(to_np(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    for f in ("wait_action", "level", "comp_changed", "feasible_any"):
        np.testing.assert_array_equal(to_np(getattr(ours.decision, f)),
                                      np.asarray(getattr(theirs.decision, f)))
    np.testing.assert_allclose(to_np(ours.t_failed), theirs.t_failed, rtol=1e-12)


def test_host_oracle_felled_and_sampled_histories(ref):
    """Sampled histories (the reference's gaps fed to both) with a felled
    survivor-slot mask and truncated runs."""
    jr = ref.jax.random
    gaps, failed = ref.sweep.renewal_failure_gaps(jr.PRNGKey(2), 24, 4, 10,
                                                  5 * 24 * 3600.0)
    felled = np.random.default_rng(3).random((24, 10, 3)) < 0.15
    for name in ("scenario1_short_reexec", "scenario5_short_idle_waits"):
        ours = S.renewal_compose(SC.paper_scenarios()[name], gaps,
                                 30 * 24 * 3600.0, failed_node=failed,
                                 felled=felled, device="cpu")
        theirs = ref.sweep.renewal_compose(
            ref.scenarios.paper_scenarios()[name], gaps, 30 * 24 * 3600.0,
            failed_node=failed, felled=felled)
        _energies_close(ours, theirs, 1e-9)
        np.testing.assert_array_equal(to_np(ours.n_failures), theirs.n_failures)
        np.testing.assert_array_equal(to_np(ours.truncated), theirs.truncated)
        assert bool(theirs.truncated.any())


def test_inputs_from_reference_packs_identical_bits(ref):
    jnp = ref.jax.numpy
    cfgs = list(ref.scenarios.paper_scenarios().values())
    _, stacked = ref.sweep._renewal_device_inputs(cfgs, jnp.float32)
    stacked_np = {f.name: np.asarray(getattr(stacked, f.name))
                  for f in dataclasses.fields(stacked)
                  if f.name not in ("ladder", "sleep", "peer")}
    stacked_np["ladder"] = {k: np.asarray(v) for k, v in
                            dataclasses.asdict(stacked.ladder).items()}
    stacked_np["sleep"] = {k: np.asarray(v) for k, v in
                           dataclasses.asdict(stacked.sleep).items()}
    stacked_np["peer"] = stacked.peer
    inp = S.inputs_from_reference(stacked_np, device="cpu")
    ours = S._pack_kernel_inputs(inp, MAKESPAN)
    theirs = ref.sweep._pack_pallas_inputs(stacked, MAKESPAN)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    # and the port's own stacking of the same configs gives the same bits
    _, own = S._renewal_device_inputs(list(SC.paper_scenarios().values()),
                                      torch.float32, "cpu")
    for a, b in zip(S._pack_kernel_inputs(own, MAKESPAN), theirs):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@pytest.fixture(scope="module")
def slice_runs(ref):
    cfgs_t = list(SC.paper_scenarios().values())
    cfgs_j = list(ref.scenarios.paper_scenarios().values())
    key_j = ref.jax.random.PRNGKey(1)
    return dict(
        ours=S.renewal_monte_carlo_scenarios(cfgs_t, prng.PRNGKey(1),
                                             engine="kernel", device="cpu",
                                             **MC),
        pallas=ref.sweep.renewal_monte_carlo_scenarios(
            cfgs_j, key_j, engine="pallas", **MC),
        host={c.name: ref.sweep.renewal_monte_carlo(c, key_j, engine="host", **MC)
              for c in cfgs_j[:2]},
    )


@pytest.mark.parametrize("against", ["pallas", "host"])
def test_slice_matches_reference(slice_runs, against):
    ours = slice_runs["ours"]
    for name, theirs in slice_runs[against].items():
        mine = ours[name]
        for f in SUMMARY_EXACT:
            assert getattr(mine, f) == getattr(theirs, f), (name, f)
        for f in SUMMARY_ENERGY:
            np.testing.assert_allclose(getattr(mine, f), getattr(theirs, f),
                                       rtol=1e-4, err_msg=f"{name} {f}")
        assert abs(mine.mean_saving_j - theirs.mean_saving_j) \
            <= 1e-4 * theirs.mean_energy_ref_j
        assert mine.mean_failures > 1.0


def test_host_engine_matches_reference_host(ref):
    cfg_t = SC.paper_scenarios()["scenario2_long_reexec"]
    cfg_j = ref.scenarios.paper_scenarios()["scenario2_long_reexec"]
    proc_t = F.Weibull.from_mtbf(0.7, 14 * 24 * 3600.0)
    proc_j = ref.failures.Weibull.from_mtbf(0.7, 14 * 24 * 3600.0)
    kw = dict(n_runs=32, max_failures=16)
    mine = S.renewal_monte_carlo(cfg_t, prng.PRNGKey(4), engine="host",
                                 process=proc_t, device="cpu", **kw)
    theirs = ref.sweep.renewal_monte_carlo(cfg_j, ref.jax.random.PRNGKey(4),
                                           engine="host", process=proc_j, **kw)
    for f in SUMMARY_EXACT:
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in SUMMARY_ENERGY:
        np.testing.assert_allclose(getattr(mine, f), getattr(theirs, f),
                                   rtol=1e-4)
    assert mine.mtbf_s == pytest.approx(theirs.mtbf_s, rel=1e-12)
    # the kernel engine on the same histories agrees with the host engine
    kern = S.renewal_monte_carlo(cfg_t, prng.PRNGKey(4), engine="kernel",
                                 process=proc_t, device="cpu", **kw)
    for f in SUMMARY_EXACT:
        assert getattr(kern, f) == getattr(mine, f), f
    np.testing.assert_allclose(kern.mean_energy_int_j, mine.mean_energy_int_j,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def grids(ref):
    ours = O.evaluate_policy_grid(
        SC.sparse_rendezvous_scenario(), O.policy_grid(**GRID),
        prng.PRNGKey(3), engine="kernel", device="cpu", **GRID_KW)
    theirs = ref.optimize.evaluate_policy_grid(
        ref.scenarios.sparse_rendezvous_scenario(),
        ref.optimize.policy_grid(**GRID), ref.jax.random.PRNGKey(3),
        engine="pallas", **GRID_KW)
    return ours, theirs


def test_policy_grid_matches_reference(grids):
    ours, theirs = grids
    assert ours.best == theirs.best
    np.testing.assert_allclose(ours.mean_energy_j, theirs.mean_energy_j,
                               rtol=1e-4)
    np.testing.assert_allclose(ours.mean_makespan_s, theirs.mean_makespan_s,
                               rtol=1e-4)
    np.testing.assert_array_equal(ours.n_failures, theirs.n_failures)
    np.testing.assert_array_equal(ours.makespan_s, theirs.makespan_s)
    np.testing.assert_array_equal(
        O.pareto_front(ours.mean_energy_j, ours.mean_makespan_s),
        O.pareto_front(theirs.mean_energy_j, theirs.mean_makespan_s))
    assert O.knee_point(ours.mean_energy_j, ours.mean_makespan_s) == \
        O.knee_point(theirs.mean_energy_j, theirs.mean_makespan_s)


def test_commensurate_interval_against_oracle(ref):
    """At a checkpoint interval that divides the rendezvous period, snapped
    failures make exact rendezvous wraps.  The reference's float32 kernel
    rounds the rendezvous anchors and ends some run a whole period away
    from its own float64 oracle; the port keeps the anchors in float64 and
    stays within 1e-4 of the oracle on the same histories (per run on the
    reference energy and the end time, on the mean for the intervened
    energy, whose single runs still meet exact ties, ROADMAP Queue 3)."""
    jr, jnp = ref.jax.random, ref.jax.numpy
    work, mtbf, n_runs, k = 2 * 24 * 3600.0, 8 * 3600.0, 64, 24
    cfg_j = ref.scenarios.apply_policy(
        ref.scenarios.sparse_rendezvous_scenario(), ckpt_interval=2400.0)
    period = cfg_j.survivors[0].rendezvous_period
    makespan = float(O.wall_makespan(work, 2400.0, 120.0))
    gaps, failed = ref.sweep.renewal_failure_gaps(jr.PRNGKey(1), n_runs, 4, k, mtbf)
    host = ref.sweep.renewal_compose(cfg_j, gaps, makespan, failed_node=failed)
    _, stacked = ref.sweep._renewal_device_inputs([cfg_j], jnp.float32)
    ops = tuple(np.array(a) for a in ref.sweep._pack_pallas_inputs(stacked, makespan))
    g32 = np.ascontiguousarray(gaps.T.astype(np.float32))
    theirs = ref.renewal_scan.renewal_scan_pallas(*ops, g32, interpret=True)
    ours = rs.renewal_scan(*(torch.from_numpy(a) for a in ops),
                           torch.from_numpy(g32))
    lane = lambda out, f: np.asarray(to_np(out[f])[0], np.float64)
    rel = lambda out, f: np.abs(lane(out, f) / getattr(host, f) - 1)
    # the reference's float32 wrap: a run ends one rendezvous period away
    off = np.abs(lane(theirs, "end_time") - host.end_time)
    assert np.abs(off - period).min() <= 1.0
    assert rel(theirs, "energy_ref").max() > 1e-2
    # the port, per run and on the mean
    assert rel(ours, "end_time").max() <= 1e-4
    assert rel(ours, "energy_ref").max() <= 1e-4
    assert rel(ours, "energy_int").max() <= 1e-3
    for f in ("energy_ref", "energy_int"):
        assert abs(lane(ours, f).mean() / getattr(host, f).mean() - 1) <= 1e-4
    np.testing.assert_array_equal(to_np(ours["n_failures"])[0], host.n_failures)


def test_policy_lane_equals_standalone_call(grids):
    """Common random numbers within the port: a grid lane is bit-identical
    to a standalone launch of that policy alone."""
    ours, _ = grids
    cfg = SC.sparse_rendezvous_scenario()
    for p in (0, len(ours.table) - 1):
        cfg_p = SC.apply_policy(cfg, **ours.table.policy(p))
        st = S.renewal_monte_carlo_device(
            cfg_p, prng.PRNGKey(3), n_runs=GRID_KW["n_runs"],
            max_failures=GRID_KW["max_failures"],
            makespan_s=float(ours.makespan_s[p]), mtbf_s=GRID_KW["mtbf_s"],
            stats=True, engine="kernel", device="cpu")
        np.testing.assert_array_equal(to_np(st.energy_int[0]).astype(np.float64),
                                      ours.energy_int[p])
        np.testing.assert_array_equal(to_np(st.n_failures[0]), ours.n_failures[p])


def test_policy_table_helpers_match_reference(ref):
    ours, theirs = O.policy_grid(**GRID), ref.optimize.policy_grid(**GRID)
    for f in ("ckpt_interval", "mu1", "mu2", "wait_mode", "move_ahead_frac"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    np.testing.assert_array_equal(
        O.wall_makespan(1e5, ours.ckpt_interval, 120.0),
        ref.optimize.wall_makespan(1e5, theirs.ckpt_interval, 120.0))
    rng = np.random.default_rng(0)
    e, m = rng.random(40), rng.random(40)
    np.testing.assert_array_equal(O.pareto_front(e, m),
                                  ref.optimize.pareto_front(e, m))
    assert O.knee_point(e, m) == ref.optimize.knee_point(e, m)


def test_next_slice_paths_raise():
    """Paths that raised here in earlier slices now run: the correlated
    topology= sampler and the fleet clusters= axis (held by
    tests/test_torch_topology.py and tests/test_torch_fleet.py).  The
    reference's engine name "pallas" is refused; the port says "kernel"."""
    from repro_torch.core import topology as T

    cfgs = list(SC.paper_scenarios().values())
    key = prng.PRNGKey(0)
    topo = T.rack_topology(4, 2, shock_mtbs_s=1e5, p_kill=0.5)
    out = S.renewal_monte_carlo_scenarios(cfgs, key, n_runs=4, max_failures=3,
                                          topology=topo, device="cpu")
    assert set(out) == {c.name for c in cfgs}
    assert S.renewal_monte_carlo(cfgs[0], key, n_runs=4, max_failures=3,
                                 topology=topo, device="cpu").n_runs == 4
    rows = O.evaluate_policy_grid(None, O.policy_grid(ckpt_interval=[3600.0]),
                                  key, work_s=1e5, mtbf_s=1e4, n_runs=4,
                                  clusters=cfgs[:2], device="cpu")
    assert [type(r) for r in rows] == [O.PolicyEvalResult] * 2
    with pytest.raises(ValueError):
        S.renewal_monte_carlo(cfgs[0], key, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        O.optimize_policy(cfgs[0], key, engine="pallas", n_runs=4,
                          max_failures=3, device="cpu")


def test_cuda_request_without_a_card_raises(monkeypatch):
    """No silent CPU fallback: asking for the card where there is none
    raises, from the entry points down to the kernel wrapper."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfgs = list(SC.paper_scenarios().values())
    key = prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.renewal_monte_carlo_scenarios(cfgs, key, n_runs=4, max_failures=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        O.evaluate_policy_grid(SC.sparse_rendezvous_scenario(),
                               O.policy_grid(ckpt_interval=[3600.0]), key,
                               work_s=1e5, mtbf_s=1e4)
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.uniform(key, (4,))
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.pack_lane_params(interval=1.0, dur=1.0, reexec0=0.0, t_down=0.0,
                            t_restart=0.0, mu1=6.0, mu2=1.0, wait_mode=0,
                            p_idle_wait=60.0, move_ahead=1.0, move_frac=0.5,
                            makespan=1.0, sleep=S.sweep_inputs(
                                cfgs[0], device="cpu").sleep)
