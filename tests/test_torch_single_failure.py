"""PyTorch port: the single-failure sweep, Monte-Carlo and planning.

Against the reference, on the CPU, at small sizes:
  * ``sweep_failure_times``/``sweep_scenarios`` with and without a mu-band:
    integer decisions (``level``, ``wait_action``, ``comp_changed``,
    ``feasible_any``, ``chain_ok``, ``plan_move``) equal, geometry equal,
    float decision fields within 1e-5 relative;
  * ``summarize`` (chain-broken points excluded) on the reference's own
    sweep arrays: equal to the reference's summary;
  * ``monte_carlo`` with the exponential and the Weibull process: the
    summary of the reference's sampled instants within 1e-5 relative (rates
    equal), the gap draws within 1e-6; the chain-topology refusal;
  * the sweep against the port's event oracle ``simulate(shift_failure)``
    pointwise, as tests/test_sweep.py::_cross_validate: decisions exact,
    savings within 1%;
  * ``evaluate_strategies_profile`` with per-node reference levels and a
    mu-band, ``expected_savings`` and ``optimal_checkpoint_interval``:
    decisions equal, floats within 1e-5.

Float32 Algorithm-1 values differ from XLA's by an ulp here and there
(operation fusion), hence 1e-5 on floats and equality on decisions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda, to_np

from repro_torch.core import failures as F
from repro_torch.core import planning as PL
from repro_torch.core import prng
from repro_torch.core import scenarios as SC
from repro_torch.core import simulator as SIM
from repro_torch.core import strategies as ST
from repro_torch.core import sweep as S
from repro_torch.core.strategies import Decision

TOL = 1e-5
OFFSETS = np.linspace(0.0, 7200.0, 64, endpoint=False) + 0.318
BAND = np.array([3.0, 4.5, 6.0, 7.5, 9.0])
SCENARIOS = sorted(SC.paper_scenarios())
INT_DECISIONS = ("level", "wait_action", "comp_changed", "feasible_any")
FLOAT_DECISIONS = ("freq_ghz", "comp_time", "wait_time", "energy_intervened",
                   "energy_reference", "saving", "saving_pct")
GEOMETRY = ("exec_rem", "ckpt_age", "delta_eff", "t_reexec", "t_failed",
            "n_ckpt", "plan_move", "chain_ok")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _chain_cfg(mod):
    """A chained topology whose shifts break the chain at some instants."""
    return mod.ScenarioConfig(
        name="chain",
        survivors=(mod.NodeStart(exec_to_rendezvous=300.0, ckpt_age=10.0),
                   mod.NodeStart(exec_to_rendezvous=420.0, ckpt_age=10.0, peer=1)),
        t_down=60.0, t_restart=60.0, t_reexec=1800.0)


def _assert_sweep_equal(ours, theirs):
    for f in INT_DECISIONS:
        np.testing.assert_array_equal(to_np(getattr(ours.decision, f)),
                                      np.asarray(getattr(theirs.decision, f)),
                                      err_msg=f)
    for f in FLOAT_DECISIONS:
        np.testing.assert_allclose(to_np(getattr(ours.decision, f)),
                                   np.asarray(getattr(theirs.decision, f)),
                                   rtol=TOL, err_msg=f)
    for f in GEOMETRY:
        np.testing.assert_array_equal(to_np(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)


@pytest.mark.parametrize("band", [None, BAND], ids=["own-mu", "mu-band"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_sweep_failure_times_matches_reference(ref, name, band):
    ours = S.sweep_failure_times(SC.paper_scenarios()[name], OFFSETS, mu1=band,
                                 device="cpu")
    theirs = ref.sweep.sweep_failure_times(ref.scenarios.paper_scenarios()[name],
                                           OFFSETS, mu1=band)
    _assert_sweep_equal(ours, theirs)


@pytest.mark.parametrize("band", [None, 4.0, BAND],
                         ids=["own-mu", "one-mu", "mu-band"])
def test_sweep_scenarios_matches_reference(ref, band):
    ours = S.sweep_scenarios(list(SC.paper_scenarios().values()), OFFSETS,
                             mu1=band, device="cpu")
    theirs = ref.sweep.sweep_scenarios(
        list(ref.scenarios.paper_scenarios().values()), OFFSETS, mu1=band)
    _assert_sweep_equal(ours, theirs)
    if band is not None and np.ndim(band):
        assert tuple(ours.decision.saving.shape) == (6, len(BAND), len(OFFSETS), 3)


def test_chained_sweep_matches_reference(ref):
    ours = S.sweep_failure_times(_chain_cfg(SIM), OFFSETS, device="cpu")
    theirs = ref.sweep.sweep_failure_times(_chain_cfg(ref.simulator), OFFSETS)
    _assert_sweep_equal(ours, theirs)
    assert not bool(ours.chain_ok.all()) and bool(ours.chain_ok.any())


def _as_port(res_j) -> S.SweepResult:
    """A reference ``SweepResult`` as torch tensors."""
    t = lambda a: torch.from_numpy(np.array(a))
    d = res_j.decision
    return S.SweepResult(
        decision=Decision(**{f.name: t(getattr(d, f.name))
                             for f in dataclasses.fields(d)}),
        **{f: t(getattr(res_j, f)) for f in GEOMETRY})


@pytest.mark.parametrize("case", ["scenario", "mu-band", "chain"])
def test_summarize_matches_reference(ref, case):
    """The reduction itself on the reference's arrays, chain-broken points
    excluded; and the port's own sweep summarised within TOL."""
    if case == "chain":
        res_j = ref.sweep.sweep_failure_times(_chain_cfg(ref.simulator), OFFSETS)
        res_t = S.sweep_failure_times(_chain_cfg(SIM), OFFSETS, device="cpu")
    else:
        band = BAND if case == "mu-band" else None
        res_j = ref.sweep.sweep_failure_times(
            ref.scenarios.paper_scenarios()["scenario4_short_active_waits"],
            OFFSETS, mu1=band)
        res_t = S.sweep_failure_times(
            SC.paper_scenarios()["scenario4_short_active_waits"], OFFSETS,
            mu1=band, device="cpu")
    theirs = ref.sweep.summarize(res_j)
    assert dataclasses.asdict(S.summarize(_as_port(res_j))) == \
        dataclasses.asdict(theirs)
    ours = S.summarize(res_t)
    for f, v in dataclasses.asdict(theirs).items():
        assert getattr(ours, f) == pytest.approx(v, rel=TOL), f
    if case == "chain":
        assert 0.0 < ours.chain_violation_rate < 1.0


def _mc_fields(summary) -> dict:
    out = dataclasses.asdict(summary)
    out.update(out.pop("annual_saving_by_strategy"))
    return out


@pytest.mark.parametrize("process", ["exponential", "weibull"])
def test_monte_carlo_matches_reference(ref, process):
    """Each side samples its own failure instants: the gap draws agree
    within a few ulp (ROADMAP.md Queue 3, item 5), but a float64 cumsum carries
    every 1-ulp difference into all later arrivals, so the summaries are
    compared on the reference's sampled instants; the port's entry point is
    that reduction on its own instants."""
    name = "scenario1_short_reexec"
    cfg_t, cfg_j = SC.paper_scenarios()[name], ref.scenarios.paper_scenarios()[name]
    key_t, key_j = prng.PRNGKey(3), ref.jax.random.PRNGKey(3)
    n, wrap = 512, 64.0 * (cfg_t.ckpt_interval + cfg_t.ckpt_duration)
    if process == "exponential":
        mtbf = 30 * 24 * 3600.0
        kw_t, kw_j = dict(mtbf_s=mtbf), dict(mtbf_s=mtbf)
        offs_j = ref.sweep.exponential_failure_offsets(key_j, n, mtbf, wrap)
        offs_t = S.exponential_failure_offsets(key_t, n, mtbf, wrap, "cpu")
        draws_t = prng.exponential(key_t, (n,), "cpu").numpy()
        draws_j = np.asarray(ref.jax.random.exponential(key_j, (n,)))
    else:
        proc_t = F.Weibull.from_mtbf(0.7, 20 * 24 * 3600.0)
        proc_j = ref.failures.Weibull.from_mtbf(0.7, 20 * 24 * 3600.0)
        kw_t, kw_j = dict(process=proc_t), dict(process=proc_j)
        mtbf = float(np.mean(proc_t.mean_s()))
        offs_j = ref.sweep.failure_offsets(key_j, n, proc_j, wrap)
        offs_t = S.failure_offsets(key_t, n, proc_t, wrap, "cpu")
        draws_t = proc_t.sample(key_t, (n,), "cpu").numpy()
        draws_j = np.asarray(proc_j.sample(key_j, (n,)))
    # a few float32 ulps: log1p (and the Weibull's pow) round differently
    np.testing.assert_allclose(draws_t, draws_j, rtol=1e-6)
    theirs = ref.sweep.monte_carlo(cfg_j, key_j, n_samples=n, **kw_j)
    on_theirs = S._monte_carlo_summary(cfg_t, offs_j, mtbf, None, "cpu")
    for f, v in _mc_fields(theirs).items():
        got = _mc_fields(on_theirs)[f]
        if f.endswith("_rate") or f.endswith("occupancy") or f == "n_samples":
            assert got == v, f
        else:
            assert got == pytest.approx(v, rel=TOL), f
    ours = S.monte_carlo(cfg_t, key_t, n_samples=n, device="cpu", **kw_t)
    assert _mc_fields(ours) == _mc_fields(
        S._monte_carlo_summary(cfg_t, offs_t, mtbf, None, "cpu"))
    assert ours.mtbf_s == pytest.approx(theirs.mtbf_s, rel=1e-12)


def test_monte_carlo_refuses_chain_breaking_topology(ref):
    with pytest.raises(ValueError, match="chained-rendezvous"):
        S.monte_carlo(_chain_cfg(SIM), prng.PRNGKey(0), n_samples=256,
                      device="cpu")
    with pytest.raises(ValueError, match="chained-rendezvous"):
        ref.sweep.monte_carlo(_chain_cfg(ref.simulator),
                              ref.jax.random.PRNGKey(0), n_samples=256)
    with pytest.raises(ValueError, match="cluster-level"):
        S.failure_offsets(prng.PRNGKey(0), 8, F.Exponential([1e5, 2e5]), 1e4,
                          "cpu")


@pytest.mark.parametrize("name", SCENARIOS)
def test_sweep_matches_event_oracle_pointwise(name):
    """The analytic sweep against two event simulations per instant (every
    4th of OFFSETS), as the reference's _cross_validate."""
    cfg = SC.paper_scenarios()[name]
    offsets = OFFSETS[::4]
    res = S.sweep_failure_times(cfg, offsets, device="cpu")
    pred = res.decision.saving.double().numpy()
    eni = res.decision.energy_reference.double().numpy()
    for t, delta in enumerate(offsets):
        shifted = SC.shift_failure(cfg, float(delta))
        ref_run = SIM.simulate(shifted, intervene=False, device="cpu")
        act = SIM.simulate(shifted, intervene=True, device="cpu")
        for i, node in enumerate(sorted(act.outcomes)):
            o = act.outcomes[node]
            measured = ref_run.outcomes[node].energy - o.energy
            assert int(res.decision.level[t, i]) == o.level
            assert int(res.decision.wait_action[t, i]) == int(o.wait_action)
            denom = max(abs(measured), 0.01 * eni[t, i], 1.0)
            assert abs(pred[t, i] - measured) / denom < 0.01


@pytest.mark.parametrize("band", [None, BAND], ids=["scalar-mu", "mu-band"])
def test_evaluate_strategies_entry_matches_reference(ref, band):
    """The entry point on seeded (T, N, F) inputs, per-node reference
    levels, and a mu-band (M, 1, 1, 1) against the wait grid."""
    rng = np.random.default_rng(7)
    shape = (40, 3)
    t_comp = rng.uniform(5.0, 4000.0, shape)
    t_failed = np.where(rng.uniform(size=shape) < 0.15,
                        rng.uniform(1.0, 50.0, shape),
                        t_comp + rng.uniform(0.0, 4000.0, shape))
    n_ckpt = rng.integers(0, 4, shape + (4,)).astype(np.float64)
    wait_mode = rng.integers(0, 2, shape)
    ref_level = np.array([0, 2, 1])
    mu1 = 6.0 if band is None else BAND[:, None, None, None]
    kw = dict(mu1=mu1, per_level_n_ckpt=True, ref_level=ref_level)
    ours = ST.evaluate_strategies_profile(
        SC.scenario(1).profile, t_comp, t_failed, n_ckpt, 120.0, wait_mode,
        device="cpu", **kw)
    theirs = ref.strategies.evaluate_strategies_profile(
        ref.scenarios.scenario(1).profile, t_comp, t_failed, n_ckpt, 120.0,
        wait_mode, **kw)
    for f in INT_DECISIONS:
        np.testing.assert_array_equal(to_np(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    for f in FLOAT_DECISIONS:
        np.testing.assert_allclose(to_np(getattr(ours, f)),
                                   np.asarray(getattr(theirs, f)), rtol=TOL,
                                   err_msg=f)
    assert not bool(ours.feasible_any.all())


def test_linspace_grid_matches_jnp(ref):
    jnp = ref.jax.numpy
    for stop, num in ((1800.0, 512), (1.0, 512), (7331.7, 100), (3600.0, 17)):
        np.testing.assert_array_equal(PL._linspace0(stop, num, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, stop, num)))


@pytest.mark.parametrize("wait_mode", [0, 1])
def test_expected_savings_matches_reference(ref, wait_mode):
    kw = dict(ckpt_interval_s=2400.0, t_down_s=60.0, t_restart_s=60.0,
              comp_to_block_s=300.0, wait_mode=wait_mode)
    ours = PL.expected_savings(SC.scenario(1).profile, device="cpu", **kw)
    theirs = ref.planning.expected_savings(ref.scenarios.scenario(1).profile, **kw)
    for f, v in dataclasses.asdict(theirs).items():
        assert getattr(ours, f) == pytest.approx(v, rel=TOL), f


def test_optimal_checkpoint_interval_matches_reference(ref):
    kw = dict(mtbf_s=36 * 3600.0, n_survivors=3)
    best_t, rows_t = PL.optimal_checkpoint_interval(SC.scenario(4).profile,
                                                    device="cpu", **kw)
    best_j, rows_j = ref.planning.optimal_checkpoint_interval(
        ref.scenarios.scenario(4).profile, **kw)
    assert best_t == best_j
    for a, b in zip(rows_t, rows_j):
        for f, v in b.items():
            assert a[f] == pytest.approx(v, rel=TOL), f


def test_single_failure_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SC.scenario(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.sweep_failure_times(cfg, OFFSETS)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.monte_carlo(cfg, prng.PRNGKey(0), n_samples=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.expected_savings(cfg.profile, ckpt_interval_s=1800.0, t_down_s=60.0,
                            t_restart_s=60.0, comp_to_block_s=300.0)


@requires_cuda
@pytest.mark.parametrize("band", [None, BAND], ids=["own-mu", "mu-band"])
def test_sweep_on_card_matches_cpu(band):
    skip_without_cuda()
    cfgs = list(SC.paper_scenarios().values())
    card = S.sweep_scenarios(cfgs, OFFSETS, mu1=band, device="cuda")
    cpu = S.sweep_scenarios(cfgs, OFFSETS, mu1=band, device="cpu")
    for f in dataclasses.fields(card.decision):
        a, b = getattr(card.decision, f.name).cpu(), getattr(cpu.decision, f.name)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=TOL, atol=0.0)
        else:
            assert torch.equal(a, b), f.name
    for f in GEOMETRY:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
