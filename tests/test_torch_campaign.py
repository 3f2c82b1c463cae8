"""PyTorch port: the campaign engine — spec composition, the content-hash
contract, store durability, the runner's resume/chunking bit-identity and
the CLI (the reference's ``tests/test_campaign.py`` contracts), against
the reference where the two meet:

  * every preset normalizes to the reference's cell configs, and
    ``cell_key`` under the reference's engine string gives the
    reference's key; under the port's own string (``renewal-torch-1``) a
    port record never addresses a reference record;
  * the smoke preset's records against the reference runner's (each side
    samples its own histories; a few gaps per key differ by an ulp):
    counts, histograms and rates exact; for the exponential cells the mean
    energies within 1e-9 relative and the savings and their percentiles
    within 1e-8 of the mean reference energy (observed 9.2e-10, 6.2e-9:
    the float32 Algorithm-1 ulps of a run's epochs); for the Weibull cells
    all of them within 1e-7 (observed 3.7e-8: ``pow`` moves more gaps by
    an ulp); the record keys equal;
  * within the port: resume recomputes zero cells, a rerun is
    bit-identical whatever the chunking, records equal a direct
    ``renewal_monte_carlo_scenarios`` / ``renewal_monte_carlo`` dispatch.
"""
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch.campaign import analyze, presets, runner, spec, store
from repro_torch.campaign import __main__ as cli
from repro_torch.core import failures as F
from repro_torch.core import prng, sweep

N_RUNS, MAX_FAILURES = 16, 8
MAKESPAN_S = 10.0 * 24 * 3600.0
MTBF_S = 7.0 * 24 * 3600.0
SCEN_A = "scenario2_long_reexec"
SCEN_B = "scenario4_short_active_waits"
REF_ENGINE = "renewal-device-1"     # the reference's ENGINE_VERSION
EXACT = ("n_runs", "max_failures", "mean_failures", "failure_count_hist",
         "per_node_failures", "truncated_rate", "sleep_occupancy",
         "min_freq_rate", "comp_change_rate", "infeasible_rate",
         "makespan_s", "mtbf_s", "mean_makespan_s")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _axes():
    scen = spec.axis("scenario", [(n, {"scenario": {"base": n}})
                                  for n in (SCEN_A, SCEN_B)])
    proc = spec.axis("process", [
        ("exp", {"process": {"kind": "exponential", "mtbf_s": MTBF_S}}),
        ("wb07", {"process": {"kind": "weibull", "k": 0.7,
                              "mtbf_s": MTBF_S}})])
    return scen, proc


def _base():
    return {"run": {"n_runs": N_RUNS, "max_failures": MAX_FAILURES,
                    "makespan_s": MAKESPAN_S},
            "seed": 0}


def _campaign(name="t"):
    scen, proc = _axes()
    return spec.campaign(name, scen * proc, base=_base())


def _run(camp, st_=None, **kw):
    return runner.run_campaign(camp, st_, device="cpu", **kw)


# ---------------------------------------------------------------------------
# spec composition
# ---------------------------------------------------------------------------

def test_cartesian_zip_and_filter():
    scen, proc = _axes()
    m = scen * proc
    assert len(m) == 4
    assert m.cells[0].label_dict == {"scenario": SCEN_A, "process": "exp"}
    assert m.cells[0].cell_id() == f"scenario={SCEN_A}/process=exp"
    assert [c.label_dict["process"] for c in m.cells] == \
        ["exp", "wb07", "exp", "wb07"]
    z = scen.zip(spec.axis("mtbf", [
        ("short", {"process": {"kind": "exponential", "mtbf_s": 1e5}}),
        ("long", {"process": {"kind": "exponential", "mtbf_s": 1e6}})]))
    assert len(z) == 2 and z.cells[1].config["process"]["mtbf_s"] == 1e6
    with pytest.raises(ValueError, match="equal lengths"):
        scen.zip(spec.axis("seed", [(str(i), {"seed": i}) for i in range(3)]))
    kept = m.filter(lambda lbl, cfg: lbl["process"] == "exp")
    assert len(kept) == 2
    assert all(c.label_dict["process"] == "exp" for c in kept.cells)


def test_composition_errors():
    a = spec.axis("a", [("x", {"policy": {"mu1": 3.0}})])
    b = spec.axis("b", [("y", {"policy": {"mu1": 4.0}})])
    with pytest.raises(ValueError, match="conflicting values for 'policy.mu1'"):
        _ = a * b
    c = spec.axis("c", [("z", {"policy": {"mu1": 3.0}})])
    assert (a * c).cells[0].config["policy"]["mu1"] == 3.0
    with pytest.raises(ValueError, match="duplicate labels"):
        spec.axis("a", [("x", {}), ("x", {})])
    scen, _ = _axes()
    dup = spec.axis("p", [("a", {"process": {"kind": "exponential",
                                             "mtbf_s": MTBF_S}}),
                          ("b", {"process": {"kind": "exponential",
                                             "mtbf_s": MTBF_S}})])
    with pytest.raises(ValueError, match="resolve to the same config"):
        spec.campaign("t", scen * dup, base=_base())


def test_validation_errors():
    scen, _ = _axes()
    with pytest.raises(ValueError, match="unknown policy knobs"):
        spec.campaign("t", scen, base={**_base(), "policy": {"nonsense": 1.0}})
    with pytest.raises(ValueError, match="exactly one of makespan_s"):
        spec.campaign("t", scen, base={
            "run": {"n_runs": 4, "max_failures": 2,
                    "makespan_s": 1e6, "work_s": 1e6},
            "process": {"kind": "exponential", "mtbf_s": MTBF_S}})
    with pytest.raises(ValueError, match="unknown scenario base"):
        spec.campaign("t", spec.axis(
            "s", [("bad", {"scenario": {"base": "no_such"}})]), base=_base())
    with pytest.raises(ValueError, match="non-finite"):
        spec.normalize_config({
            "scenario": {"base": SCEN_A},
            "process": {"kind": "exponential", "mtbf_s": float("nan")},
            "run": {"n_runs": 4, "max_failures": 2, "makespan_s": 1e6}})


def test_policy_grid_preset_matches_optimize_grid_order():
    from repro_torch.core import optimize

    camp = presets.policy_grid()
    table = optimize.policy_grid(
        ckpt_interval=np.asarray(presets.OPT_INTERVALS),
        mu1=list(presets.OPT_MU1), wait_mode=[0, 1])
    assert len(camp.cells) == len(table) == 42
    for p, cell in enumerate(camp.cells):
        pol = table.policy(p)
        assert cell.config["policy"]["ckpt_interval"] == \
            pytest.approx(pol["ckpt_interval"])
        assert cell.config["policy"]["mu1"] == pytest.approx(pol["mu1"])
        assert cell.config["policy"]["wait_mode"] == pol["wait_mode"]


def test_fleet_preset_addresses_cluster_scenarios():
    from repro_torch.fleet import cluster_scenario

    camp = presets.fleet()
    assert len(camp.cells) == 6
    for cell in camp.cells:
        sc = cell.config["scenario"]
        assert sc["base"] == "fleet_cluster"
        cfg = spec.build_scenario(sc)
        want = cluster_scenario(**{k: v for k, v in sc.items() if k != "base"})
        assert cfg.name == want.name and cfg.survivors == want.survivors
        assert len(cfg.survivors) == sc["n_nodes"] - 1


def test_custom_registration_never_suppresses_builtins(monkeypatch):
    monkeypatch.setattr(spec, "_SCENARIO_BUILDERS", {})
    monkeypatch.setattr(spec, "_builtins_done", False)
    spec.register_scenario("custom_probe", lambda: None)
    names = spec.scenario_names()
    assert "custom_probe" in names and "sparse_rendezvous" in names
    assert SCEN_A in names


# ---------------------------------------------------------------------------
# content-hash contract
# ---------------------------------------------------------------------------

def _config(mtbf=MTBF_S, n_runs=N_RUNS, seed=0, interval=None):
    cfg = {"scenario": {"base": SCEN_A},
           "process": {"kind": "exponential", "mtbf_s": mtbf},
           "run": {"n_runs": n_runs, "max_failures": MAX_FAILURES,
                   "makespan_s": MAKESPAN_S},
           "seed": seed}
    if interval is not None:
        cfg["policy"] = {"ckpt_interval": interval}
    return cfg


def _reordered(d):
    if isinstance(d, dict):
        return {k: _reordered(d[k]) for k in reversed(list(d))}
    return d


def test_cell_key_invariances():
    cfg = spec.normalize_config(_config(interval=3600.0))
    assert store.cell_key(cfg) == store.cell_key(_reordered(cfg))
    scen, proc = _axes()
    keys_ab = {store.cell_key(c.config)
               for c in spec.campaign("ab", scen * proc, base=_base()).cells}
    keys_ba = {store.cell_key(c.config)
               for c in spec.campaign("ba", proc * scen, base=_base()).cells}
    assert keys_ab == keys_ba
    a = spec.normalize_config(_config(mtbf=np.float64(MTBF_S)))
    b = spec.normalize_config(_config(mtbf=float(MTBF_S)))
    assert store.cell_key(a) == store.cell_key(b)


@settings(max_examples=20, deadline=None)
@given(st.floats(min_value=1e4, max_value=1e7),
       st.integers(min_value=1, max_value=64),
       st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=600.0, max_value=86400.0))
def test_cell_key_changes_on_any_field_change(mtbf, n_runs, seed, interval):
    key0 = store.cell_key(spec.normalize_config(_config(interval=3600.0)))
    for variant in (
        _config(mtbf=mtbf * 1.0000001, interval=3600.0),
        _config(n_runs=n_runs + N_RUNS, interval=3600.0),
        _config(seed=seed + 1, interval=3600.0),
        _config(interval=interval + 100000.0),
        _config(interval=None),
    ):
        assert store.cell_key(spec.normalize_config(variant)) != key0
    assert store.cell_key(spec.normalize_config(_config(interval=3600.0)),
                          engine_version="other") != key0


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_presets_and_cell_keys_match_reference(ref, name):
    """Every preset declares the reference's cells: labels and normalized
    configs equal, and under the reference's engine string the content
    address is the reference's; under the port's own it never is."""
    ours = presets.PRESETS[name]()
    theirs = ref.campaign.presets.PRESETS[name]()
    assert ours.name == theirs.name and len(ours) == len(theirs)
    assert store.ENGINE_VERSION == "renewal-torch-1"
    assert ref.campaign.store.ENGINE_VERSION == REF_ENGINE
    for a, b in zip(ours.cells, theirs.cells):
        assert a.labels == b.labels
        assert store.canonical_json(a.config) == \
            ref.campaign.store.canonical_json(b.config)
        assert store.cell_key(a.config, REF_ENGINE) == \
            ref.campaign.store.cell_key(b.config)
        assert store.cell_key(a.config) != ref.campaign.store.cell_key(b.config)


# ---------------------------------------------------------------------------
# store durability
# ---------------------------------------------------------------------------

def _fake_record(i):
    return dict(labels={"i": str(i)}, config={"cell": i},
                result={"value": float(i)}, meta={"wall_s": 0.1})


def test_store_roundtrip_and_idempotent_put(tmp_path):
    st_ = store.ResultStore(tmp_path, shard_size=2)
    for i in range(5):
        st_.put(f"k{i}", **_fake_record(i))
    assert len(st_) == 5
    first = st_.get("k0")
    assert st_.put("k0", **_fake_record(99)) is first
    st2 = store.ResultStore(tmp_path)
    assert st2.keys() == {f"k{i}" for i in range(5)}
    assert st2.get("k3")["result"] == {"value": 3.0}
    assert len(list((tmp_path / "shards").glob("cells-*.jsonl"))) >= 2
    idx = json.loads((tmp_path / "index.json").read_text())
    assert idx["engine"] == "renewal-torch-1"


def test_store_skips_torn_trailing_line(tmp_path):
    st_ = store.ResultStore(tmp_path)
    for i in range(3):
        st_.put(f"k{i}", **_fake_record(i))
    shard = next((tmp_path / "shards").glob("cells-*.jsonl"))
    with open(shard, "a") as f:
        f.write('{"key": "k_torn", "labels": {}, "resu')   # kill mid-write
    st2 = store.ResultStore(tmp_path)
    assert st2.keys() == {"k0", "k1", "k2"}
    st2.put("k_torn", **_fake_record(9))
    reloaded = store.ResultStore(tmp_path)
    assert reloaded.has("k_torn") and len(reloaded) == 4


def test_store_heals_corrupt_or_stale_index(tmp_path):
    st_ = store.ResultStore(tmp_path)
    for i in range(3):
        st_.put(f"k{i}", **_fake_record(i))
    good = (tmp_path / "index.json").read_text()
    idx = json.loads(good)
    assert set(idx) == {"version", "engine", "checksum", "cells"}

    def reopen_and_check():
        assert store.ResultStore(tmp_path).keys() == {"k0", "k1", "k2"}
        assert json.loads((tmp_path / "index.json").read_text()) == \
            json.loads(good)

    (tmp_path / "index.json").write_text('{"version": 1, "garb')
    reopen_and_check()
    (tmp_path / "index.json").unlink()
    reopen_and_check()
    (tmp_path / "index.json").write_text(json.dumps(
        dict(idx, cells={"k0": idx["cells"]["k0"]})))
    reopen_and_check()
    (tmp_path / "index.json").write_text(json.dumps(
        dict(idx, checksum="0" * 64)))
    reopen_and_check()
    (tmp_path / "index.json").write_text(json.dumps(
        dict(idx, engine=REF_ENGINE)))        # another engine's index
    reopen_and_check()
    before = (tmp_path / "index.json").read_text()
    store.ResultStore(tmp_path)
    assert (tmp_path / "index.json").read_text() == before


def test_store_rejects_non_finite_and_diffs(tmp_path):
    st_ = store.ResultStore(tmp_path / "n")
    with pytest.raises(ValueError):
        st_.put("k", labels={}, config={}, result={"v": float("inf")})
    assert len(st_) == 0
    a, b = store.ResultStore(tmp_path / "a"), store.ResultStore(tmp_path / "b")
    a.put("k0", **_fake_record(0))
    b.put("k0", **_fake_record(0))
    assert store.diff_stores(tmp_path / "a", tmp_path / "b") == []
    a.put("k1", **_fake_record(1))
    rec2 = _fake_record(2)
    rec2["result"] = {"value": -1.0}
    b.put("k2", **rec2)
    diffs = store.diff_stores(tmp_path / "a", tmp_path / "b")
    assert len(diffs) == 2 and any("k1" in d for d in diffs)
    recm = _fake_record(3)
    a.put("k3", **recm)
    recm["meta"] = {"wall_s": 999.0}
    b.put("k3", **recm)
    assert not any("k3" in d
                   for d in store.diff_stores(tmp_path / "a", tmp_path / "b"))
    rows = [{"name": "campaign/cells_4", "us_per_call": 1.0,
             "decisions_per_s": 2.0, "derived": "x"}]
    a.put_bench_rows(rows)
    assert store.ResultStore(tmp_path / "a").bench_rows() == rows
    assert store.is_store(tmp_path / "a")
    assert not store.is_store(tmp_path / "nope")


# ---------------------------------------------------------------------------
# runner: resume, chunking, bit-identity, parity
# ---------------------------------------------------------------------------

def test_resume_recomputes_zero_completed_cells(tmp_path):
    camp = _campaign()
    rep1 = _run(camp, store.ResultStore(tmp_path), limit=3)
    assert (rep1.n_computed, rep1.n_skipped) == (3, 0)
    rep2 = _run(camp, store.ResultStore(tmp_path))
    assert (rep2.n_computed, rep2.n_skipped) == (1, 3)
    rep3 = _run(camp, store.ResultStore(tmp_path))
    assert (rep3.n_computed, rep3.n_skipped, rep3.n_chunks) == (0, 4, 0)
    assert [r["labels"] for r in rep3.records] == \
        [c.label_dict for c in camp.cells]


def test_rerun_is_bit_identical_and_chunking_invisible(tmp_path):
    camp = _campaign()
    _run(camp, store.ResultStore(tmp_path / "fused"))
    rep = _run(camp, store.ResultStore(tmp_path / "lanes"),
               chunk_budget_mb=1e-6)
    assert rep.n_chunks == 4
    assert store.diff_stores(tmp_path / "fused", tmp_path / "lanes") == []
    st3 = store.ResultStore(tmp_path / "resumed")
    _run(camp, st3, limit=1)
    _run(camp, store.ResultStore(tmp_path / "resumed"))
    assert store.diff_stores(tmp_path / "fused", tmp_path / "resumed") == []


def test_campaign_matches_direct_dispatch():
    """Stacked heterogeneous lanes reproduce the scenario-path engine bit
    for bit, iid and under a rack topology."""
    from repro_torch.core import topology as T
    from repro_torch.core.scenarios import paper_scenarios

    camp = spec.campaign("parity", _axes()[0], base={
        **_base(), "process": {"kind": "exponential", "mtbf_s": MTBF_S}})
    recs = _run(camp).records
    direct = sweep.renewal_monte_carlo_scenarios(
        [paper_scenarios()[n] for n in (SCEN_A, SCEN_B)], prng.PRNGKey(0),
        n_runs=N_RUNS, makespan_s=MAKESPAN_S, mtbf_s=MTBF_S,
        max_failures=MAX_FAILURES, device="cpu")
    for rec, summ in zip(recs, direct.values()):
        got = {k: v for k, v in rec["result"].items() if k != "mean_makespan_s"}
        assert got == runner.summary_to_result(summ)
    topo_spec = {"kind": "rack", "rack_size": 2,
                 "shock_mtbs_s": 5.0 * 24 * 3600.0, "p_kill": 0.9}
    corr = spec.campaign("corr", spec.axis(
        "topology", [("iid", {}), ("rack", {"topology": topo_spec})]), base={
        "scenario": {"base": SCEN_A},
        "process": {"kind": "exponential", "mtbf_s": MTBF_S}, **_base()})
    recs = {r["labels"]["topology"]: r for r in _run(corr).records}
    cfg = paper_scenarios()[SCEN_A]
    topo = T.rack_topology(len(cfg.survivors) + 1, 2,
                           shock_mtbs_s=5.0 * 24 * 3600.0, p_kill=0.9)
    for label, topology in (("iid", None), ("rack", topo)):
        one = sweep.renewal_monte_carlo(
            cfg, prng.PRNGKey(0), n_runs=N_RUNS, makespan_s=MAKESPAN_S,
            max_failures=MAX_FAILURES, process=F.Exponential(MTBF_S),
            topology=topology, device="cpu")
        got = {k: v for k, v in recs[label]["result"].items()
               if k != "mean_makespan_s"}
        assert got == runner.summary_to_result(one), label
    assert recs["rack"]["result"]["mean_failures"] != \
        recs["iid"]["result"]["mean_failures"]


def test_records_match_reference_runner(ref):
    ours = _run(presets.smoke()).records
    theirs = ref.campaign.runner.run_campaign(
        ref.campaign.presets.smoke()).records
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a["labels"] == b["labels"] and a["config"] == b["config"]
        assert a["key"] == store.cell_key(b["config"])
        assert b["key"] == store.cell_key(a["config"], REF_ENGINE)
        exp = a["labels"]["process"] == "exp"
        ref_j = abs(b["result"]["mean_energy_ref_j"])
        scales = {"mean_saving_pct": 100.0, "annual_saving_j": ref_j
                  * sweep.SECONDS_PER_YEAR / b["result"]["makespan_s"]}
        assert set(a["result"]) == set(b["result"])
        for f, v in b["result"].items():
            if f in EXACT:
                assert a["result"][f] == v, (a["labels"], f)
            else:       # energies, savings and their percentiles
                tol = (1e-9 if f.startswith("mean_energy") else 1e-8) \
                    if exp else 1e-7
                assert abs(a["result"][f] - v) <= tol * scales.get(f, ref_j), \
                    (a["labels"], f)


def test_topology_cell_key_resolves_and_changes_hash():
    base = {"scenario": {"base": SCEN_A},
            "process": {"kind": "exponential", "mtbf_s": MTBF_S}, **_base()}
    corr = dict(base, topology={"kind": "rack", "rack_size": 2,
                                "shock_mtbs_s": 5.0 * 24 * 3600.0,
                                "p_kill": 0.9})
    n_base, n_corr = spec.normalize_config(base), spec.normalize_config(corr)
    assert store.cell_key(n_base) != store.cell_key(n_corr)
    assert spec.resolve(n_corr).topology is not None
    assert spec.resolve(n_base).topology is None
    with pytest.raises(ValueError, match="topology"):
        spec.normalize_config(dict(base, topology={
            "kind": "rack", "rack_size": 2, "shock_mtbs_s": 1.0, "bogus": 1}))
    with pytest.raises(ValueError, match="kind"):
        spec.normalize_config(dict(base, topology={
            "kind": "mesh", "rack_size": 2, "shock_mtbs_s": 1.0}))


def test_chunk_lanes_and_offending_cell():
    camp = _campaign()
    exp = spec.resolve(camp.cells[0].config)
    assert runner._chunk_lanes(100, exp, chunk_budget_mb=1e9) == 100
    assert runner._chunk_lanes(100, exp, chunk_budget_mb=1e-9) == 1
    per_lane = 2.0 * exp.n_runs * exp.max_failures * \
        (96 + 88 * (len(exp.cfg.survivors) + 1))
    assert runner._chunk_lanes(100, exp, per_lane * 3 / 1e6) == 3
    bad = spec.campaign("bad", spec.axis(
        "scenario", [(SCEN_A, {"scenario": {"base": SCEN_A}})]), base={
        **_base(), "policy": {"ckpt_interval": 1.0},
        "process": {"kind": "exponential", "mtbf_s": MTBF_S}})
    with pytest.raises(ValueError, match=f"scenario={SCEN_A}"):
        _run(bad)


def test_analyze_verbs_and_tables(tmp_path):
    recs = _run(_campaign(), store.ResultStore(tmp_path)).records
    assert len(analyze.select(recs, process="exp")) == 2
    assert set(analyze.group_by(recs, "scenario")) == {SCEN_A, SCEN_B}
    assert isinstance(analyze.get(recs[0], "result.mean_saving_j"), float)
    assert analyze.get(recs[0], "result.not_there", -1.0) == -1.0
    rows_lbl, cols_lbl, grid = analyze.pivot(
        recs, "scenario", "process", "result.mean_failures")
    assert rows_lbl == [SCEN_A, SCEN_B] and cols_lbl == ["exp", "wb07"]
    assert all(v is not None for row in grid for v in row)
    md = analyze.summary_table(
        recs, [("scenario", lambda r: analyze.label(r, "scenario")),
               ("E[fail]", ("result.mean_failures", ".1f"))])
    assert md.count("\n") == len(recs) + 1 and md.startswith("| scenario")
    txt = analyze.summary_table(recs, [("s", "labels.scenario")], fmt="text")
    assert "---" in txt.splitlines()[1]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_seeded_chaos_cut_matches_reference(ref):
    for seed in (0, 1, 42, 123456789):
        n = cli._seeded_cut(seed, 12)
        assert cli._seeded_cut(seed, 12) == n and 1 <= n < 12
        assert n == ref.campaign.cli._seeded_cut(seed, 12)
    assert len({cli._seeded_cut(s, 12) for s in range(40)}) > 3
    assert cli._seeded_cut(7, 1) == 1 and cli._seeded_cut(7, 2) == 1


def test_cli_cut_resume_and_diff(tmp_path, capsys):
    """``run --limit-seed`` then ``run --expect-skipped-seed`` on the CPU
    equals an uninterrupted run (``diff`` exits 0); a rerun computes zero
    cells; a wrong expectation exits 1."""
    cut, full = str(tmp_path / "cut"), str(tmp_path / "full")
    run = ["run", "--preset", "smoke", "--device", "cpu"]
    assert cli.main(run + ["--store", cut, "--limit-seed", "3"]) == 0
    n_cut = cli._seeded_cut(3, 4)
    assert len(store.ResultStore(cut)) == n_cut
    assert cli.main(run + ["--store", cut, "--expect-skipped-seed", "3"]) == 0
    assert cli.main(run + ["--store", full, "--table"]) == 0
    capsys.readouterr()
    assert cli.main(["diff", cut, full]) == 0
    assert "stores match: 4 cells" in capsys.readouterr().out
    assert cli.main(run + ["--store", full, "--expect-skipped", "4"]) == 0
    assert "0 computed, 4 skipped" in capsys.readouterr().out
    assert cli.main(run + ["--store", full, "--expect-skipped", "3"]) == 1
    assert cli.main(["show", "--store", full]) == 0
    assert "E[failures]" in capsys.readouterr().out
    assert cli.main(["list"]) == 0
    assert "policy_grid" in capsys.readouterr().out
    assert cli.main(["run", "--preset", "nope", "--device", "cpu"]) == 1


def test_cli_device_defaults_to_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "smoke", "--store", str(tmp_path)])
    assert len(store.ResultStore(tmp_path)) == 0


@requires_cuda
def test_campaign_on_card(tmp_path):
    """On the card: one-lane chunks give the fused run's records, and the
    exponential cells equal a direct scenario dispatch on the card."""
    skip_without_cuda()
    from repro_torch.core.scenarios import paper_scenarios

    camp = _campaign()
    fused = runner.run_campaign(camp, store.ResultStore(tmp_path / "fused"),
                                device="cuda")
    runner.run_campaign(camp, store.ResultStore(tmp_path / "lanes"),
                        chunk_budget_mb=1e-6, device="cuda")
    assert store.diff_stores(tmp_path / "fused", tmp_path / "lanes") == []
    direct = sweep.renewal_monte_carlo_scenarios(
        [paper_scenarios()[n] for n in (SCEN_A, SCEN_B)], prng.PRNGKey(0),
        n_runs=N_RUNS, makespan_s=MAKESPAN_S, mtbf_s=MTBF_S,
        max_failures=MAX_FAILURES, device="cuda")
    exp = [r for r in fused.records if r["labels"]["process"] == "exp"]
    for rec, summ in zip(exp, direct.values()):
        got = {k: v for k, v in rec["result"].items() if k != "mean_makespan_s"}
        assert got == runner.summary_to_result(summ)
