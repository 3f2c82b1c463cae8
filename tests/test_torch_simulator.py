"""PyTorch port: the event oracle and Table 4 against the reference.

  * ``simulate`` for both ``intervene`` values on the six Table-4 scenarios,
    a chained topology and non-fa start levels: per-node levels and actions
    equal, energies and phase times within 1e-6 relative;
  * ``simulate_run`` on seeded gaps, with and without felled survivors:
    whole-run energies within 1e-6 relative, per-epoch decisions equal;
  * ``compare`` (Table 4): the 18 rows' actions equal the reference's and
    the published ones, ``save_j`` within 1e-6 relative of the reference's
    and within tests/test_scenarios.py's bars of the published values;
  * ``failure_state_at``/``shift_failure`` bit-equal in float64 over a delta
    grid that includes checkpoint snaps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch.core import failures as F
from repro_torch.core import prng
from repro_torch.core import scenarios as SC
from repro_torch.core import simulator as SIM
from repro_torch.core import topology as T

TOL = 1e-6
SCENARIOS = sorted(SC.paper_scenarios())
# deltas past several checkpoint periods, and onto checkpoint boundaries
# (scenario 1's first timer fires at 1200 s and lasts to 1320 s; the
# 3600 s-interval scenarios' at 2100 / 3540 s)
DELTAS = np.concatenate([np.linspace(0.0, 20000.0, 41),
                         [1200.0, 1260.0, 1320.0, 2100.0, 2160.0, 3540.0,
                          3600.0, 3660.0, 5400.0, 7200.0]])


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _twin(ref, cfg):
    """The reference's copy of a port config (same values, its classes)."""
    R = ref.simulator
    survivors = tuple(R.NodeStart(**dataclasses.asdict(s)) for s in cfg.survivors)
    prof = cfg.profile
    rprof = ref.characterization.MachineProfile(
        **{f.name: getattr(prof, f.name) for f in dataclasses.fields(prof)
           if f.name not in ("power_table", "sleep")},
        power_table=ref.characterization.PowerTable(
            **dataclasses.asdict(prof.power_table)),
        sleep=ref.characterization.SleepSpec(**dataclasses.asdict(prof.sleep)))
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("survivors", "profile", "wait_mode")}
    return R.ScenarioConfig(survivors=survivors, profile=rprof,
                            wait_mode=ref.energy_model.WaitMode(int(cfg.wait_mode)),
                            **kw)


def _extra_configs():
    chain = SIM.ScenarioConfig(
        name="chain",
        survivors=(SIM.NodeStart(exec_to_rendezvous=300.0, ckpt_age=10.0),
                   SIM.NodeStart(exec_to_rendezvous=420.0, ckpt_age=10.0, peer=1)),
        t_down=60.0, t_restart=60.0, t_reexec=1800.0)
    s2 = SC.paper_scenarios()["scenario2_long_reexec"]
    nonfa = dataclasses.replace(s2, name="nonfa", survivors=tuple(
        dataclasses.replace(sv, level=lv) for sv, lv in zip(s2.survivors, (1, 0, 2))))
    return {"chain": chain, "nonfa": nonfa}


def _configs():
    return dict(SC.paper_scenarios(), **_extra_configs())


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("intervene", [False, True])
@pytest.mark.parametrize("name", SCENARIOS + ["chain", "nonfa"])
def test_simulate_matches_reference(ref, name, intervene):
    cfg = _configs()[name]
    ours = SIM.simulate(cfg, intervene, device="cpu")
    theirs = ref.simulator.simulate(_twin(ref, cfg), intervene)
    assert sorted(ours.outcomes) == sorted(theirs.outcomes)
    for node, t in theirs.outcomes.items():
        o = ours.outcomes[node]
        assert (o.level, int(o.wait_action)) == (t.level, int(t.wait_action)), node
        for f in ("energy", "comp_phase", "wait_phase", "window",
                  "predicted_saving", "freq_ghz"):
            assert _rel(getattr(o, f), getattr(t, f)) <= TOL or \
                getattr(o, f) == getattr(t, f), (node, f)
    assert [(s.node, s.phase.value, s.level) for s in ours.segments] == \
        [(s.node, s.phase.value, s.level) for s in theirs.segments]
    np.testing.assert_allclose([(s.t0, s.t1, s.power) for s in ours.segments],
                               [(s.t0, s.t1, s.power) for s in theirs.segments],
                               rtol=TOL)


@pytest.mark.parametrize("with_felled", [False, True])
@pytest.mark.parametrize("name", ["scenario1_short_reexec",
                                  "scenario4_short_active_waits",
                                  "scenario5_short_idle_waits"])
def test_simulate_run_matches_reference(ref, name, with_felled):
    rng = np.random.default_rng(11)
    gaps = rng.exponential(6000.0, 8)
    felled = (rng.random((8, 3)) < 0.3) if with_felled else None
    if with_felled:
        felled[2] = True          # one epoch fells every survivor
    cfg = SC.paper_scenarios()[name]
    ours = SIM.simulate_run(cfg, gaps, 45000.0, felled=felled, device="cpu")
    theirs = ref.simulator.simulate_run(_twin(ref, cfg), gaps, 45000.0,
                                        felled=felled)
    assert ours.n_failures == theirs.n_failures > 2
    for f in ("energy_ref", "energy_int", "saving", "end_time",
              "balanced_energy"):
        assert _rel(getattr(ours, f), getattr(theirs, f)) <= TOL, f
    for eo, et in zip(ours.epochs, theirs.epochs):
        np.testing.assert_array_equal(eo.levels, et.levels)
        assert [int(a) for a in eo.wait_actions] == [int(a) for a in et.wait_actions]
        np.testing.assert_allclose(eo.saving, et.saving, rtol=TOL, atol=1e-6)
        assert _rel(eo.t_fail, et.t_fail) <= TOL or eo.t_fail == et.t_fail


def test_simulate_run_samples_the_renewal_engines_history():
    """``gaps=None`` draws one run's history with the renewal engines'
    sampler: the same run as passing those gaps explicitly."""
    cfg = SC.paper_scenarios()["scenario2_long_reexec"]
    proc = F.Weibull.from_mtbf(0.8, 9000.0)
    key = prng.PRNGKey(5)
    drawn = SIM.simulate_run(cfg, None, 60000.0, process=proc, key=key,
                             max_failures=12, device="cpu")
    gaps, _ = F.sample_renewal_gaps(proc, key, 1, 12, 4, "cpu")
    explicit = SIM.simulate_run(cfg, gaps[0].double().numpy(), 60000.0,
                                device="cpu")
    assert drawn.n_failures == explicit.n_failures > 1
    assert drawn.energy_int == explicit.energy_int
    with pytest.raises(ValueError, match="OR a process"):
        SIM.simulate_run(cfg, gaps[0].numpy(), 6e4, process=proc, device="cpu")
    with pytest.raises(ValueError, match="requires a FailureProcess"):
        SIM.simulate_run(cfg, None, 6e4, device="cpu")
    # a topology draws the history and the felled sets itself (the
    # correlated sampler of core.topology), never beside explicit gaps
    topo = T.rack_topology(4, 4, shock_mtbs_s=2e4, p_kill=0.9)
    shocked = SIM.simulate_run(cfg, None, 60000.0, process=proc, key=key,
                               topology=topo, max_failures=12, device="cpu")
    g, fm, pri = T.correlated_renewal_gaps(topo, proc, key, 1, 4, 12, "cpu")
    again = SIM.simulate_run(cfg, g[0], 60000.0,
                             felled=T.survivor_slot_mask(fm, pri)[0],
                             device="cpu")
    assert shocked.n_failures == again.n_failures > 1
    assert shocked.energy_int == again.energy_int
    with pytest.raises(ValueError, match="topology needs gaps=None"):
        SIM.simulate_run(cfg, gaps[0].numpy(), 6e4, topology=topo, device="cpu")


@pytest.mark.parametrize("name", SCENARIOS)
def test_compare_matches_reference_and_published(ref, name):
    cfg = SC.paper_scenarios()[name]
    rows, _, _ = SIM.compare(cfg, device="cpu")
    theirs, _, _ = ref.simulator.compare(_twin(ref, cfg))
    rel_bar, pct_bar = SC.table4_bars(name)
    assert len(rows) == len(theirs) == 3
    for r, t in zip(rows, theirs):
        comp, wait, save_j, save_pct = SC.TABLE4_PUBLISHED[(name, r.node)]
        assert (r.comp_action, r.wait_action) == (t.comp_action, t.wait_action) \
            == (comp, wait)
        assert _rel(r.save_j, t.save_j) <= TOL
        for f in ("comp_phase_min", "wait_phase_min", "total_min",
                  "save_j_per_s", "save_pct"):
            assert _rel(getattr(r, f), getattr(t, f)) <= TOL, f
        assert _rel(r.save_j, save_j) <= rel_bar
        assert abs(r.save_pct - save_pct) < pct_bar


@pytest.mark.parametrize("name", SCENARIOS + ["chain"])
def test_failure_state_and_shift_bit_equal(ref, name):
    cfg = _configs()[name]
    twin = _twin(ref, cfg)
    snapped = 0
    for delta in DELTAS:
        ours = SC.failure_state_at(cfg, float(delta))
        theirs = ref.scenarios.failure_state_at(twin, float(delta))
        for f in ("exec_rem", "ckpt_age", "delta_eff"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
        for f in ("delta", "t_reexec", "t_recover", "delta_eff_failed"):
            assert getattr(ours, f) == getattr(theirs, f), f
        snapped += int(np.any(ours.delta_eff != delta))
        try:
            theirs_cfg = ref.scenarios.shift_failure(twin, float(delta))
        except ValueError:
            with pytest.raises(ValueError, match="wrapped past its peer"):
                SC.shift_failure(cfg, float(delta))
            continue
        ours_cfg = SC.shift_failure(cfg, float(delta))
        assert ours_cfg.name == theirs_cfg.name
        assert ours_cfg.t_reexec == theirs_cfg.t_reexec
        assert [dataclasses.astuple(s) for s in ours_cfg.survivors] == \
            [dataclasses.astuple(s) for s in theirs_cfg.survivors]
    assert snapped > 0          # the grid lands inside checkpoints
    with pytest.raises(ValueError, match="delta"):
        SC.failure_state_at(cfg, -1.0)


def test_simulate_validates_inputs():
    cfg = SC.paper_scenarios()["scenario1_short_reexec"]
    bad_level = dataclasses.replace(cfg, survivors=(
        dataclasses.replace(cfg.survivors[0], level=9),) + cfg.survivors[1:])
    with pytest.raises(ValueError, match="outside ladder"):
        SIM.simulate(bad_level, True, device="cpu")
    bad_chain = dataclasses.replace(cfg, survivors=(
        dataclasses.replace(cfg.survivors[0], peer=2),) + cfg.survivors[1:])
    with pytest.raises(ValueError, match="precede"):
        SIM.simulate(bad_chain, True, device="cpu")
    overdue = dataclasses.replace(cfg, t_reexec=cfg.ckpt_interval + 1.0)
    with pytest.raises(ValueError, match="exceed"):
        SC.failure_state_at(overdue, 10.0)


def test_simulate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SC.paper_scenarios()["scenario1_short_reexec"]
    with pytest.raises(RuntimeError, match="CUDA"):
        SIM.compare(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SIM.simulate_run(cfg, [5000.0], 1e4)


@requires_cuda
@pytest.mark.parametrize("name", SCENARIOS)
def test_compare_on_card_matches_cpu(name):
    skip_without_cuda()
    cfg = SC.paper_scenarios()[name]
    card, _, _ = SIM.compare(cfg, device="cuda")
    cpu, _, _ = SIM.compare(cfg, device="cpu")
    for a, b in zip(card, cpu):
        assert (a.comp_action, a.wait_action) == (b.comp_action, b.wait_action)
        assert _rel(a.save_j, b.save_j) <= TOL
