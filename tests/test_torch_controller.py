"""PyTorch port: the closed loop FTTrainer <-> renewal engine, case by case
as ``tests/test_controller.py``, against the JAX reference where it
computes the same thing.

The trainer is driven by the failure histories the renewal engine samples
(the port's ``core.prng`` keys, bit-compatible with the reference's), so
its realized ledger reconciles against the engine exactly
(``renewal_compose`` on the realized gaps: < 1e-5) and in expectation
(``renewal_monte_carlo_device`` at the injector's key: < 12 %, the
reference's documented step-quantization tolerance).  The model is a tiny
functional update, as in the reference's test: the energy loop touches
only step counts and wall clocks.

Bars against the reference: injector histories with the failing node
equal and gaps within 1e-5 of gap + the oldest clock's age (the bar of
``test_torch_failures.py``; the Weibull transform's ``pow`` differs by
ulps between backends); ledgers, retuned policies and reconcile reports
within 1e-6 relative; discrete decisions, failure steps and counts equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointConfig
from repro_torch.core import failures, optimize, prng, sweep
from repro_torch.ft import (AdaptiveController, ClusterSpec, FTTrainer,
                            StochasticFailureInjector, cluster_scenario,
                            reconcile_ledger)

KEY_SEED = 3
N_PODS = 4
STEP_S = 100.0
DUR_S = 120.0
PROCESS = failures.Weibull.from_mtbf(0.7, 2000.0)
TOL_RESIDUAL = 1e-5
TOL_REF = 1e-6


@pytest.fixture(scope="module")
def R():
    return load_reference()


class TinyPipeline:
    def batch_at(self, step):
        return torch.full((4,), float(step))


def _tiny_step(params, opt_state, batch):
    g = batch.mean() * 0.01
    params = tree_map(lambda p: p - 0.001 * (p + g), params)
    return params, opt_state, {"total_loss": batch.mean()}


def _injector(max_failures=32, n_runs=4, run_index=1, process=PROCESS):
    return StochasticFailureInjector(process, prng.PRNGKey(KEY_SEED),
                                     n_pods=N_PODS, max_failures=max_failures,
                                     n_runs=n_runs, run_index=run_index,
                                     device="cpu")


def _trainer(root, *, injector, interval_steps=6, controller=None, **kw):
    state = ({"w": torch.ones((8,))}, {"m": torch.zeros((8,))})
    return FTTrainer(
        step_fn=_tiny_step, pipeline=TinyPipeline(), state=state,
        cluster=ClusterSpec(n_pods=N_PODS, step_time_s=STEP_S),
        ckpt_cfg=CheckpointConfig(root=str(root),
                                  interval_steps=interval_steps, keep=3,
                                  phase_offset_steps=1),
        injector=injector, ckpt_duration_s=DUR_S, controller=controller,
        device="cpu", **kw)


def _ref_trainer(R, root, *, injector, interval_steps=6, controller=None):
    jax, jnp = R.jax, R.jax.numpy
    rt = R.ft_runtime

    class Pipe:
        def batch_at(self, step):
            return jnp.full((4,), float(step))

    @jax.jit
    def step(params, opt_state, batch):
        g = jnp.mean(batch) * 0.01
        params = jax.tree.map(lambda p: p - 0.001 * (p + g), params)
        return params, opt_state, {"total_loss": jnp.mean(batch)}

    return rt.FTTrainer(
        step_fn=step, pipeline=Pipe(),
        state=({"w": jnp.ones((8,))}, {"m": jnp.zeros((8,))}),
        cluster=rt.ClusterSpec(n_pods=N_PODS, step_time_s=STEP_S),
        ckpt_cfg=R.checkpoint.CheckpointConfig(
            root=str(root), interval_steps=interval_steps, keep=3,
            phase_offset_steps=1),
        injector=injector, ckpt_duration_s=DUR_S, controller=controller)


def _ref_injector(R, process=None):
    proc = process or R.failures.Weibull.from_mtbf(0.7, 2000.0)
    return R.ft_controller.StochasticFailureInjector(
        proc, R.jax.random.PRNGKey(KEY_SEED), n_pods=N_PODS, max_failures=32,
        n_runs=4, run_index=1)


def _close(a, b, tol=TOL_REF):
    return abs(a - b) <= tol * max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# injector <-> engine history identity
# ---------------------------------------------------------------------------

def test_injector_replays_engine_history(R):
    inj = _injector()
    gaps, failed = sweep.renewal_failure_gaps(prng.PRNGKey(KEY_SEED), 4, N_PODS,
                                              32, process=PROCESS, device="cpu")
    np.testing.assert_array_equal(inj.gaps, gaps[1].numpy())
    np.testing.assert_array_equal(inj.failed_node, failed[1].numpy())
    first = float(inj.gaps[0])
    assert inj.poll(0, first - STEP_S - 1.0, STEP_S) is None
    pod = inj.poll(0, first - 0.5 * STEP_S, STEP_S)
    assert pod == int(inj.failed_node[0])
    inj.confirm(0)
    assert inj.n_fired == 1
    with pytest.raises(ValueError):
        StochasticFailureInjector(PROCESS, prng.PRNGKey(KEY_SEED), n_pods=N_PODS,
                                  n_runs=2, run_index=2, device="cpu")
    # the reference's injector at the same key
    ref = _ref_injector(R)
    np.testing.assert_array_equal(inj.failed_node, ref.failed_node)
    oldest = R.failures.failure_clock_ages(ref.gaps[None], ref.failed_node[None],
                                           N_PODS)[0].max(axis=-1)
    assert np.all(np.abs(inj.gaps - ref.gaps) <= TOL_RESIDUAL * (ref.gaps + oldest))


def test_injector_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StochasticFailureInjector(PROCESS, prng.PRNGKey(0), n_pods=N_PODS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveController(PROCESS, n_pods=N_PODS)


# ---------------------------------------------------------------------------
# end-to-end reconciliation
# ---------------------------------------------------------------------------

def test_ledger_reconciles_with_renewal_engine(R, tmp_path):
    tr = _trainer(tmp_path / "ck", injector=_injector())
    tr.run(60)
    assert len(tr.events) >= 3
    rep = reconcile_ledger(tr, device="cpu")
    assert rep.n_failures == len(tr.events)
    assert rep.rel_err_compose < 1e-5
    assert rep.mc_j is not None and rep.rel_err_mc < 0.12
    em_ = tr.energy
    total = em_.steps_j + em_.ckpt_j + em_.resync_j \
        + sum(e.epoch_int_j for e in em_.events)
    assert rep.ledger_j == pytest.approx(total)
    assert em_.ledger_reference_j() >= em_.ledger_total_j()
    # the reference's trainer on its own injector at the same key
    jt = _ref_trainer(R, tmp_path / "j", injector=_ref_injector(R))
    jt.run(60)
    jrep = R.ft_controller.reconcile_ledger(jt)
    assert [e["step"] for e in tr.events] == [e["step"] for e in jt.events]
    assert [e["pod"] for e in tr.events] == [e["pod"] for e in jt.events]
    assert rep.n_failures == jrep.n_failures
    assert rep.makespan_s == jrep.makespan_s
    for f in ("ledger_j", "compose_j", "mc_j"):
        assert _close(getattr(rep, f), getattr(jrep, f)), f


def test_ledger_reconciles_without_failures(tmp_path):
    calm = failures.Exponential(mtbf_s=1e12)
    tr = _trainer(tmp_path / "ck", injector=_injector(process=calm))
    tr.run(24)
    assert tr.events == []
    rep = reconcile_ledger(tr, mc=False, device="cpu")
    assert rep.rel_err_compose < 1e-9
    assert rep.mc_j is None and rep.rel_err_mc is None
    assert tr.energy.resync_j == 0.0


def test_run_is_deterministic_bit_for_bit(tmp_path):
    runs = []
    for sub in ("a", "b"):
        tr = _trainer(tmp_path / sub, injector=_injector())
        tr.run(40)
        runs.append(tr)
    a, b = runs
    assert a.energy.ledger_total_j() == b.energy.ledger_total_j()
    assert [e["gap_s"] for e in a.events] == [e["gap_s"] for e in b.events]
    assert [e.epoch_int_j for e in a.energy.events] == \
        [e.epoch_int_j for e in b.energy.events]
    assert torch.equal(a.state[0]["w"], b.state[0]["w"])


# ---------------------------------------------------------------------------
# adaptive controller
# ---------------------------------------------------------------------------

def _controller(mod, prior, **kw):
    extra = {"device": "cpu"} if mod is AdaptiveController else {}
    return mod(prior, n_pods=N_PODS, retune_every=2, min_complete_gaps=3,
               cem_iters=2, cem_population=10, cem_n_runs=32,
               cem_max_failures=32, seed=0, **extra, **kw)


def test_adaptive_controller_beats_static_default(R, tmp_path):
    static = _trainer(tmp_path / "s", injector=_injector(), interval_steps=1)
    static.run(60)
    static_j = static.energy.ledger_total_j()
    ctl = _controller(AdaptiveController, failures.Exponential(mtbf_s=8000.0))
    adaptive = _trainer(tmp_path / "a", injector=_injector(), interval_steps=1,
                        controller=ctl)
    adaptive.run(60)
    adaptive_j = adaptive.energy.ledger_total_j()

    assert ctl.retunes and ctl.fitted is not None
    assert adaptive.cluster.ckpt_interval_s != static.cluster.ckpt_interval_s
    assert adaptive.managers[0].cfg.interval_steps > 1
    assert any(e["policy"] is not None for e in adaptive.events)
    assert adaptive.cluster.ckpt_interval_s == pytest.approx(
        adaptive.managers[0].cfg.interval_steps * STEP_S)
    assert adaptive_j < static_j

    cl, fin = static.cluster, adaptive.cluster
    table = optimize.PolicyTable(
        ckpt_interval=np.asarray([cl.ckpt_interval_s, fin.ckpt_interval_s]),
        mu1=np.asarray([cl.mu1, fin.mu1]), mu2=np.asarray([cl.mu2, fin.mu2]),
        wait_mode=np.asarray([int(cl.wait_mode), int(fin.wait_mode)], np.int32),
        move_ahead_frac=np.asarray([cl.move_ahead_frac, fin.move_ahead_frac]))
    res = optimize.evaluate_policy_grid(
        cluster_scenario(cl, ckpt_duration_s=DUR_S), table, prng.PRNGKey(11),
        work_s=6000.0, n_runs=64, max_failures=32, process=PROCESS,
        device="cpu")
    assert res.mean_energy_j[1] <= res.mean_energy_j[0]


def test_retunes_match_reference(R, tmp_path):
    """The same adaptive run on both packages: failure steps, what each
    retune observed and fitted, and the policy it chose."""
    ctl = _controller(AdaptiveController, failures.Exponential(mtbf_s=8000.0))
    tr = _trainer(tmp_path / "t", injector=_injector(), interval_steps=1,
                  controller=ctl)
    tr.run(60)
    jctl = _controller(R.ft_controller.AdaptiveController,
                       R.failures.Exponential(mtbf_s=8000.0))
    jt = _ref_trainer(R, tmp_path / "j", injector=_ref_injector(R),
                      interval_steps=1, controller=jctl)
    jt.run(60)
    assert [(e["step"], e["pod"]) for e in tr.events] == \
        [(e["step"], e["pod"]) for e in jt.events]
    assert len(ctl.retunes) == len(jctl.retunes) > 0
    for r, j in zip(ctl.retunes, jctl.retunes):
        assert (r.step, r.n_observed, r.process_label) == \
            (j.step, j.n_observed, j.process_label)
        assert r.policy["wait_mode"] == j.policy["wait_mode"]
        for k in optimize.CEM_KNOBS:
            assert _close(r.policy[k], j.policy[k]), k
        assert _close(r.score_j, j.score_j)
    assert _close(tr.energy.ledger_total_j(), jt.energy.ledger_total_j())


def test_observe_fit_competing_risks(R):
    ctl = AdaptiveController(failures.Exponential(mtbf_s=1000.0), n_pods=3,
                             min_complete_gaps=3, device="cpu")
    jctl = R.ft_controller.AdaptiveController(
        R.failures.Exponential(mtbf_s=1000.0), n_pods=3, min_complete_gaps=3)
    ctl.observe_failure(gap_s=100.0, failed_pod=0)
    np.testing.assert_allclose(ctl._ages, [0.0, 100.0, 100.0])
    assert ctl.complete_gaps == [100.0]
    assert ctl.fit() is None
    ctl.observe_failure(gap_s=50.0, failed_pod=1)
    assert ctl.complete_gaps[-1] == 150.0
    ctl.observe_failure(gap_s=200.0, failed_pod=0)
    np.testing.assert_allclose(ctl._ages, [0.0, 200.0, 350.0])
    for g, p in ((100.0, 0), (50.0, 1), (200.0, 0)):
        jctl.observe_failure(gap_s=g, failed_pod=p)
    fitted, jfitted = ctl.fit(), jctl.fit()
    assert isinstance(fitted, failures.Weibull)
    k = float(np.asarray(fitted.k))
    assert ctl.k_bounds[0] <= k <= ctl.k_bounds[1]
    assert _close(k, float(np.asarray(jfitted.k)), 1e-12)
    assert _close(float(np.asarray(fitted.scale_s)),
                  float(np.asarray(jfitted.scale_s)), 1e-12)
    np.testing.assert_allclose(ctl.pit, jctl.pit, rtol=1e-12, atol=1e-15)
    ctl2 = AdaptiveController(failures.Exponential(mtbf_s=1000.0), n_pods=3,
                              min_complete_gaps=3, device="cpu")
    for _ in range(5):
        ctl2.observe_failure(gap_s=0.0, failed_pod=0)
    assert ctl2.fit() is None


def test_burst_detector_matches_reference(R):
    """Zero gaps (a correlated burst replayed) trip the misfit detector on
    both packages at the same observation; calm gaps do not."""
    for gaps in ([0.0, 0.0, 500.0, 0.0, 700.0, 0.0, 0.0, 300.0, 0.0],
                 [400.0, 900.0, 1500.0, 300.0, 700.0, 2200.0, 650.0, 1200.0,
                  800.0]):
        ctl = AdaptiveController(failures.Exponential(mtbf_s=4000.0),
                                 n_pods=N_PODS, degrade=True, device="cpu")
        jctl = R.ft_controller.AdaptiveController(
            R.failures.Exponential(mtbf_s=4000.0), n_pods=N_PODS, degrade=True)
        states = []
        for i, g in enumerate(gaps):
            for c in (ctl, jctl):
                c.observe_failure(gap_s=g, failed_pod=i % N_PODS)
            states.append((ctl.burst_active(), jctl.burst_active()))
        assert all(a == b for a, b in states)
        np.testing.assert_allclose(ctl.pit, jctl.pit, rtol=1e-12, atol=1e-15)
    assert states[-1] == (False, False)


def test_cluster_scenario_geometry(R):
    cl = ClusterSpec(n_pods=4, step_time_s=100.0)
    cfg = cluster_scenario(cl, ckpt_duration_s=60.0, ckpt_interval_s=600.0)
    assert len(cfg.survivors) == 3
    for s in cfg.survivors:
        assert s.exec_to_rendezvous == 100.0
        assert s.rendezvous_period == 100.0
        assert s.ckpt_age == 0.0
    assert cfg.t_reexec == 0.0
    assert cfg.ckpt_interval == 600.0
    want = R.ft_controller.cluster_scenario(
        R.ft_runtime.ClusterSpec(n_pods=4, step_time_s=100.0),
        ckpt_duration_s=60.0, ckpt_interval_s=600.0)
    for f in dataclasses.fields(cfg):
        if f.name in ("profile", "survivors", "wait_mode"):
            continue
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    assert int(cfg.wait_mode) == int(want.wait_mode)
    with pytest.raises(ValueError):
        cluster_scenario(ClusterSpec(n_pods=1))
