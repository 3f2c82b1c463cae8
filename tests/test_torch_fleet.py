"""PyTorch port: the fleet ``clusters=`` axis and the fleet advisor.

Within the port (the reference's ``tests/test_fleet.py`` contracts):

  * **fleet CRN** — every cluster row of the ``(C, P)`` scan equals a
    standalone ``optimize_policy`` / ``evaluate_policy_grid`` call for that
    cluster alone at the same key, bit for bit, for exponential and
    Weibull clusters; the batched sampler's lanes equal the standalone
    sampler for every process family;
  * **padding** is inert, answers come back in **submit order**, empty and
    singleton flushes work, ``shard=True`` equals the unsharded path;
  * **memoization** — the LRU bound, ``clear``, trace counting, a repeat
    fleet shape never rebuilding its program, a new node count missing;
  * every refusal of the reference raises the same exception type.

Against the reference:

  * on the same histories (the port's sampled gaps fed to the reference's
    ``renewal_compose_policies``) the ``(C, P)`` stats' float64 geometry
    (end times, balanced energy) within 1e-12, counts exact, and whole-run
    energies within 2 float32 ulps of the per-epoch Algorithm-1 energies
    they sum (the fold is float32 on both sides and its last bit is the
    backend's; at these 5-14 day horizons that is up to 5e-9 of the whole
    run, above the scan's 1e-9 bar of shorter runs);
  * each side sampling its own histories at the same key (a few gaps per
    key differ by an ulp: ``log1p``/``pow`` are the backends' own), the
    fleet dispatch's counts and action rates are exact, the argmin, Pareto
    front and knee equal, per-run energies within 1e-6 relative (observed
    up to 1.5e-7 over 16 days of work).
"""
import dataclasses

import numpy as np
import pytest

from torch_port_ref import (load_reference, requires_cuda, skip_without_cuda,
                            to_np)

from repro_torch import fleet
from repro_torch.core import energy_model as em
from repro_torch.core import failures as F
from repro_torch.core import optimize as O
from repro_torch.core import prng
from repro_torch.core import sweep as S

KEY = prng.PRNGKey(11)
N_RUNS = 8
MAX_FAILURES = 6
KW = dict(n_runs=N_RUNS, max_failures=MAX_FAILURES)
CPU = dict(KW, device="cpu")
FIELDS = ("energy_ref", "energy_int", "saving", "end_time", "n_failures",
          "mean_energy_j", "mean_makespan_s", "makespan_s",
          "sleep_occupancy", "min_freq_rate", "infeasible_rate")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _grid(mod=O):
    return mod.policy_grid(ckpt_interval=[3600.0, 7200.0, 14400.0], mu1=[6.0],
                           wait_mode=[em.WaitMode.ACTIVE, em.WaitMode.IDLE])


def _fleet(n=4, *, family_frac=0.0, seed=2, node_buckets=(4,), mod=fleet):
    return mod.synthetic_fleet(n, seed=seed, node_buckets=node_buckets,
                               weibull_frac=family_frac)


def _advisor(**kw):
    return fleet.FleetAdvisor(_grid(), key=KEY, device="cpu", **KW, **kw)


def _solo(profile, table):
    """The reference answer within the port: this cluster tuned alone."""
    return O.optimize_policy(
        profile.scenario(), KEY, table=table,
        process=profile.failure_process(), work_s=profile.work_s, **CPU)


def _assert_grids_bitwise(got, want, label):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{label} field {f}")


# ---------------------------------------------------------------------------
# fleet CRN: per-cluster rows == standalone calls, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family_frac", [0.0, 1.0],
                         ids=["exponential", "weibull"])
def test_fleet_rows_bit_identical_to_standalone(family_frac):
    table = _grid()
    profiles = _fleet(3, family_frac=family_frac)
    batch = O.optimize_policy(None, KEY, table=table,
                              clusters=[p.spec() for p in profiles], **CPU)
    assert len(batch) == len(profiles)
    for p, opt in zip(profiles, batch):
        solo = _solo(p, table)
        _assert_grids_bitwise(opt.grid, solo.grid, p.name)
        assert opt.best == solo.best and opt.knee == solo.knee, p.name
        np.testing.assert_array_equal(opt.pareto, solo.pareto)


def test_evaluate_policy_grid_clusters_matches_single():
    table = _grid()
    profiles = _fleet(3, family_frac=1.0, seed=5)
    rows = O.evaluate_policy_grid(
        None, table, KEY, work_s=6 * 24 * 3600.0,
        clusters=[(p.scenario(), p.failure_process()) for p in profiles],
        **CPU)
    for p, got in zip(profiles, rows):
        want = O.evaluate_policy_grid(
            p.scenario(), table, KEY, work_s=6 * 24 * 3600.0,
            process=p.failure_process(), **CPU)
        _assert_grids_bitwise(got, want, p.name)
    # bare configs take the call-level process
    bare = O.evaluate_policy_grid(
        None, table, KEY, makespan_s=4e5, mtbf_s=6e5,
        clusters=[p.scenario() for p in profiles], **CPU)
    want = O.evaluate_policy_grid(profiles[1].scenario(), table, KEY,
                                  makespan_s=4e5, mtbf_s=6e5, **CPU)
    _assert_grids_bitwise(bare[1], want, "bare")
    # no table: the first cluster's default grid at its process MTBF
    opts = O.optimize_policy(None, KEY, clusters=[p.spec() for p in profiles],
                             **CPU)
    default = O.default_policy_table(profiles[0].scenario(),
                                     float(profiles[0].failure_process().mean_s()))
    np.testing.assert_array_equal(opts[2].grid.table.ckpt_interval,
                                  default.ckpt_interval)
    assert len(opts[2].grid) == 42


def test_fleet_policy_inputs_lanes_match_policy_inputs():
    table = _grid()
    cfgs = [p.scenario() for p in _fleet(3, seed=9)]
    stacked = O.fleet_policy_inputs(cfgs, table, "cpu")
    for c, cfg in enumerate(cfgs):
        solo = O.policy_inputs(cfg, table, "cpu")
        for f in S._LEAVES:
            np.testing.assert_array_equal(to_np(getattr(stacked, f)[c]),
                                          to_np(getattr(solo, f)), err_msg=f)
        for group, names in (("ladder", S._LADDER), ("sleep", S._SLEEP)):
            for f in names:
                np.testing.assert_array_equal(
                    to_np(getattr(getattr(stacked, group), f)[c]),
                    to_np(getattr(getattr(solo, group), f)))
        assert stacked.peer == solo.peer


def _family(name, c, rng):
    m = float(rng.uniform(2e5, 2e6))
    return {"exponential": lambda: F.Exponential(m),
            "weibull": lambda: F.Weibull.from_mtbf(float(rng.uniform(0.6, 0.95)), m),
            "weibull-per-node": lambda: F.Weibull.from_mtbf(rng.uniform(0.6, 0.95, 4), m),
            "lognormal": lambda: F.LogNormal.from_mtbf(m, 1.0),
            "gamma": lambda: F.Gamma.from_mtbf(0.5, m),
            "trace": lambda: F.EmpiricalTrace(rng.weibull(0.8, 48) * m)}[name]()


@pytest.mark.parametrize("name", ["exponential", "weibull", "weibull-per-node",
                                  "lognormal", "gamma", "trace"])
def test_fleet_sampler_lanes_equal_standalone(name):
    """One batched pass over C clusters draws, lane for lane, what the
    standalone sampler draws for each cluster alone at the same key."""
    rng = np.random.default_rng(4)
    procs = [_family(name, c, rng) for c in range(5)]
    gaps, failed = F.sample_fleet_renewal_gaps(F.stack_processes(procs), KEY,
                                               13, 7, 4, "cpu")
    assert tuple(gaps.shape) == (5, 13, 7)
    for c, p in enumerate(procs):
        g, f = F.sample_renewal_gaps(p, KEY, 13, 7, 4, "cpu")
        assert np.array_equal(to_np(gaps[c]), to_np(g)), (name, c)
        assert np.array_equal(to_np(failed[c]), to_np(f)), (name, c)
    with pytest.raises(ValueError, match="cluster"):
        F.fleet_size(F.Exponential(1e5))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family_frac", [0.0, 1.0],
                         ids=["exponential", "weibull"])
def test_fleet_stats_match_reference_on_shared_histories(ref, family_frac):
    """The port's (C, P) dispatch against the reference's scan fed the
    same (the port's) histories, cluster by cluster: 1e-9, counts exact."""
    profiles = _fleet(3, family_frac=family_frac, seed=7)
    table_t, table_j = _grid(), _grid(ref.optimize)
    specs = [p.spec() for p in profiles]
    makespans = np.stack([O.wall_makespan(s.work_s, table_t.ckpt_interval,
                                          s.cfg.ckpt_duration) for s in specs])
    proc = F.stack_processes([s.process for s in specs])
    stats = S._stats_to_host(S.renewal_monte_carlo_policies(
        O.fleet_policy_inputs([s.cfg for s in specs], table_t, "cpu"), KEY,
        makespan_s=makespans, process=proc, n_runs=16, max_failures=8))
    assert stats["energy_int"].shape == (3, len(table_t), 16)
    gaps, _ = F.sample_fleet_renewal_gaps(proc, KEY, 16, 8, 4, "cpu")
    profiles_j = _fleet(3, family_frac=family_frac, seed=7, mod=ref.fleet)
    for c, p in enumerate(profiles_j):
        out = ref.sweep.renewal_compose_policies(
            ref.optimize.policy_inputs(p.scenario(), table_j),
            to_np(gaps[c]).astype(np.float64), makespans[c])
        for f in ("end_time", "balanced_energy"):
            np.testing.assert_allclose(stats[f][c], np.asarray(getattr(out, f)),
                                       rtol=1e-12, atol=0, err_msg=f)
        # the epochs' Algorithm-1 energies are float32 values whose last bit
        # may differ between the backends: a whole-run energy may move by
        # 2 float32 ulps of the epoch energies it sums (observed <= 5e-9
        # of the whole run at these 5-14 day horizons)
        for f, epochs in (("energy_ref", out.epoch_ref),
                          ("energy_int", out.epoch_int)):
            budget = 2.0 ** -23 * np.abs(np.asarray(epochs)).sum(axis=(2, 3))
            want = np.asarray(getattr(out, f))
            assert np.all(np.abs(stats[f][c] - want)
                          <= budget + 1e-12 * want), f
            assert np.max(np.abs(stats[f][c] / want - 1)) <= 1e-8, f
        for f in ("n_failures", "truncated"):
            np.testing.assert_array_equal(stats[f][c], np.asarray(getattr(out, f)))


@pytest.mark.parametrize("family_frac", [0.0, 1.0],
                         ids=["exponential", "weibull"])
def test_fleet_dispatch_matches_reference(ref, family_frac):
    """Each side samples its own histories at the same key."""
    ours = O.optimize_policy(
        None, KEY, table=_grid(),
        clusters=[p.spec() for p in _fleet(3, family_frac=family_frac)], **CPU)
    theirs = ref.optimize.optimize_policy(
        None, ref.jax.random.PRNGKey(11), table=_grid(ref.optimize),
        clusters=[p.spec() for p in _fleet(3, family_frac=family_frac,
                                             mod=ref.fleet)], **KW)
    for a, b in zip(ours, theirs):
        g, h = a.grid, b.grid
        for f in ("n_failures", "truncated", "sleep_occupancy",
                  "min_freq_rate", "infeasible_rate", "end_time",
                  "makespan_s"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(h, f)),
                                          err_msg=f)
        for f in ("energy_ref", "energy_int"):
            np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(h, f)),
                                       rtol=1e-6, atol=0, err_msg=f)
        assert g.best == h.best and g.scenario == h.scenario
        assert g.process_label == h.process_label and g.mtbf_s == h.mtbf_s
        np.testing.assert_array_equal(a.pareto, np.asarray(b.pareto))
        assert a.knee["ckpt_interval"] == b.knee["ckpt_interval"]


def test_profiles_match_reference(ref):
    for kw in ({}, {"node_buckets": (4,), "weibull_frac": 0.0}):
        ours = fleet.synthetic_fleet(16, seed=3, **kw)
        theirs = ref.fleet.synthetic_fleet(16, seed=3, **kw)
        for p, q in zip(ours, theirs):
            assert dataclasses.asdict(p) == dataclasses.asdict(q)
            assert p.bucket_key() == q.bucket_key()
            a, b = p.scenario(), q.scenario()
            assert a.name == b.name
            assert [dataclasses.astuple(n) for n in a.survivors] == \
                [dataclasses.astuple(n) for n in b.survivors]
            for f in ("p_comp", "p_ckpt", "beta", "gamma", "freq_ghz"):
                np.testing.assert_array_equal(
                    getattr(a.profile.power_table, f),
                    getattr(b.profile.power_table, f))
            assert dataclasses.asdict(a.profile.sleep) == \
                dataclasses.asdict(b.profile.sleep)
            assert p.failure_process().label() == q.failure_process().label()
    a = fleet.cluster_scenario(n_nodes=8, power_scale=0.8)
    b = ref.fleet.cluster_scenario(n_nodes=8, power_scale=0.8)
    assert a.name == b.name and a.profile.p_base == b.profile.p_base
    assert [dataclasses.astuple(n) for n in a.survivors] == \
        [dataclasses.astuple(n) for n in b.survivors]


# ---------------------------------------------------------------------------
# padding inertness and scatter order
# ---------------------------------------------------------------------------

def test_padding_is_inert():
    """5 requests through an 8-wide bucket (3 padded lanes) give the same
    bits as the exact-fit dispatch."""
    profiles = _fleet(5, seed=4)
    exact = _advisor(buckets=(5,)).advise(profiles)
    padded = _advisor(buckets=(8,)).advise(profiles)
    for a, b in zip(exact, padded):
        _assert_grids_bitwise(b.optimum.grid, a.optimum.grid, a.profile.name)
        assert a.best == b.best and a.knee == b.knee


def test_scatter_returns_submit_order():
    profiles = fleet.synthetic_fleet(7, seed=6, node_buckets=(4, 8),
                                     weibull_frac=0.5)
    order = [3, 0, 6, 2, 5, 1, 4]
    shuffled = [profiles[i] for i in order]
    advisories = _advisor().advise(shuffled)
    assert [a.request_id for a in advisories] == list(range(len(shuffled)))
    assert len({p.bucket_key() for p in shuffled}) > 1
    solo = _advisor()
    for a, p in zip(advisories, shuffled):
        assert a.profile is p
        (alone,) = solo.advise([p])
        _assert_grids_bitwise(a.optimum.grid, alone.optimum.grid, p.name)


def test_empty_and_singleton_flush():
    # no table: the advisor builds the default grid around its MTBF anchor
    advisor = fleet.FleetAdvisor(key=KEY, device="cpu", **KW)
    assert len(advisor.table) == 42
    assert advisor.flush() == []
    profile = fleet.ClusterProfile()
    assert advisor.submit(profile) == 0
    (a,) = advisor.flush()
    assert a.profile is profile and a.best == a.optimum.best
    assert advisor.flush() == []        # queue drained


def test_sharded_path_matches_unsharded():
    """``shard=True`` splits the cluster axis over the devices (one part on
    the CPU): bit-identical to the unsharded dispatch, its programs in a
    cache of their own whose counters the advisor aggregates."""
    profiles = _fleet(3, seed=8)
    plain = _advisor().advise(profiles)
    sharded = _advisor(shard=True)
    for a, b in zip(plain, sharded.advise(profiles)):
        _assert_grids_bitwise(b.optimum.grid, a.optimum.grid, a.profile.name)
        assert a.best == b.best and a.knee == b.knee
    stats = sharded.cache_stats()
    assert stats.misses == 1 and stats.traces == 1
    assert sharded._shard_devices() == [sharded.device]


def test_256_cluster_fleet_one_program():
    table = _grid()
    profiles = _fleet(256, seed=0)
    advisor = _advisor()
    advisories = advisor.advise(profiles)
    assert len(advisories) == 256
    stats = advisor.cache_stats()
    assert stats.misses == 1 and stats.traces == 1 and stats.entries == 1
    assert len({a.profile.mtbf_s for a in advisories}) == 256
    for c in (0, 101, 255):
        solo = _solo(profiles[c], table)
        _assert_grids_bitwise(advisories[c].optimum.grid, solo.grid, f"c{c}")
        assert advisories[c].best == solo.best


# ---------------------------------------------------------------------------
# memoization: hits, misses, eviction
# ---------------------------------------------------------------------------

def test_repeat_fleet_shape_never_retraces():
    advisor = _advisor()
    advisor.advise(_fleet(3, seed=1))
    first = advisor.cache_stats()
    assert first.misses == 1 and first.traces == 1
    # a DIFFERENT fleet padding into the same 4-wide bucket reuses the
    # bucket's program
    advisor.advise(_fleet(4, seed=2))
    again = advisor.cache_stats()
    assert again.traces == first.traces
    assert again.hits == first.hits + 1 and again.misses == first.misses


def test_new_node_count_bucket_misses():
    advisor = _advisor()
    advisor.advise(_fleet(2, node_buckets=(4,)))
    advisor.advise(_fleet(2, node_buckets=(8,)))
    stats = advisor.cache_stats()
    assert stats.misses == 2 and stats.entries == 2


def test_dispatch_cache_lru_eviction():
    calls = []
    cache = fleet.DispatchCache(lambda x: x + 1, max_entries=2,
                                compile=lambda f: (calls.append(1), f)[1])
    for k in ("a", "b", "a", "c"):          # c evicts b (a was refreshed)
        assert cache.get(k)(0) == 1
    assert len(cache) == 2 and len(calls) == 3
    assert "b" not in cache and "a" in cache and "c" in cache
    st = cache.stats()
    assert (st.hits, st.misses, st.evictions) == (1, 3, 1)
    cache.get("b")(0)                       # re-entry is a fresh miss
    assert cache.stats().misses == 4
    with pytest.raises(ValueError):
        fleet.DispatchCache(lambda x: x, max_entries=0)


def test_dispatch_cache_clear():
    cache = fleet.DispatchCache(lambda x: x + 1, max_entries=4)
    cache.get("a")(np.ones(2))
    cache.get("b")
    cache.clear()
    assert len(cache) == 0 and "a" not in cache
    st = cache.stats()
    assert st.evictions == 2 and st.entries == 0
    assert st.traces == 1               # the paid first call survives the clear


def test_dispatch_cache_trace_counting():
    """``traces`` counts the first call of an entry: the program is built
    once per bucket key, and a repeat call is not a new trace."""
    cache = fleet.DispatchCache(lambda x: x * 2)
    fn = cache.get("k")
    assert cache.trace_count("k") == 0      # built lazily
    fn(np.ones(3))
    fn(np.ones(3))
    assert cache.trace_count("k") == 1
    fn(np.ones(4))
    assert cache.trace_count("k") == 1 and cache.stats().traces == 1
    assert cache.trace_count("absent") == 0


# ---------------------------------------------------------------------------
# error paths: the cluster axis refuses silent misuse, as the reference
# ---------------------------------------------------------------------------

def _refusals(mod, fleet_mod, key):
    table = mod.policy_grid(ckpt_interval=[3600.0, 7200.0], mu1=[6.0],
                            wait_mode=[0, 1])
    spec = fleet_mod.ClusterProfile().spec()
    exp = fleet_mod.ClusterProfile(family="exponential").spec()
    wb = fleet_mod.ClusterProfile(family="weibull").spec()
    n8 = fleet_mod.ClusterProfile(n_nodes=8).spec()
    scenario = fleet_mod.ClusterProfile().scenario()
    g = lambda **kw: mod.evaluate_policy_grid(None, table, key, **kw)
    return {
        "cfg with clusters": lambda kw: mod.optimize_policy(
            scenario, key, clusters=[spec], **kw),
        "refine with clusters": lambda kw: mod.optimize_policy(
            None, key, clusters=[spec], refine=True, **kw),
        "no clusters": lambda kw: mod.optimize_policy(None, key, clusters=[],
                                                      **kw),
        "grid cfg with clusters": lambda kw: mod.evaluate_policy_grid(
            scenario, table, key, work_s=1e5, clusters=[spec], **kw),
        "topology": lambda kw: g(work_s=1e5, clusters=[exp],
                                 topology=object(), **kw),
        "mixed families": lambda kw: g(work_s=1e5, clusters=[exp, wb], **kw),
        "survivor count": lambda kw: g(work_s=1e5, clusters=[exp, n8], **kw),
        "neither work nor makespan": lambda kw: g(clusters=[exp], **kw),
        "work_s override with makespan_s": lambda kw: g(
            makespan_s=1e5, clusters=[exp], **kw),
        "kernel engine": lambda kw: g(work_s=1e5, clusters=[exp],
                                      engine="kernel" if mod is O else "pallas",
                                      **kw),
    }


@pytest.mark.parametrize("case", sorted(_refusals(O, fleet, KEY)))
def test_clusters_refusals_match_reference(ref, case):
    ours = _refusals(O, fleet, KEY)[case]
    theirs = _refusals(ref.optimize, ref.fleet, ref.jax.random.PRNGKey(11))[case]
    with pytest.raises(Exception) as e_j:
        theirs(KW)
    with pytest.raises(Exception) as e_t:
        ours(CPU)
    assert type(e_t.value) is type(e_j.value), (e_t.value, e_j.value)


def test_policies_cluster_axis_refusals():
    """``renewal_monte_carlo_policies`` on a (C, P) stack: kernel engine,
    per-epoch view, topology, an unstacked process, a process stacked over
    another cluster count and a makespan of the wrong shape raise."""
    from repro_torch.core import topology as T

    specs = [p.spec() for p in _fleet(2)]
    table = _grid()
    stacked = O.fleet_policy_inputs([s.cfg for s in specs], table, "cpu")
    proc = F.stack_processes([s.process for s in specs])
    ms = np.full((2, len(table)), 4e5)
    run = lambda **kw: S.renewal_monte_carlo_policies(
        stacked, KEY, **dict(dict(makespan_s=ms, process=proc, **KW), **kw))
    assert tuple(run().energy_int.shape) == (2, len(table), N_RUNS)
    for bad, match in (
            (dict(engine="kernel"), "scan engine"),
            (dict(stats=False), "stats-only"),
            (dict(topology=T.rack_topology(4, 2, shock_mtbs_s=1e5)),
             "single-cluster"),
            (dict(process=specs[0].process), "stacked"),
            (dict(process=F.stack_processes([specs[0].process] * 3)),
             "stacked"),
            (dict(makespan_s=ms[0]), r"\(C, P\)")):
        with pytest.raises(ValueError, match=match):
            run(**bad)


def test_profile_validation():
    with pytest.raises(ValueError, match="nodes"):
        fleet.ClusterProfile(n_nodes=1)
    with pytest.raises(ValueError, match="family"):
        fleet.ClusterProfile(family="lognormal")
    with pytest.raises(ValueError, match="positive"):
        fleet.ClusterProfile(mtbf_s=-1.0)
    with pytest.raises(ValueError, match=">= 1"):
        fleet.synthetic_fleet(0)
    cfg = fleet.cluster_scenario(n_nodes=8, power_scale=0.8)
    assert cfg.name == "fleet_n8_x0.8" and len(cfg.survivors) == 7
    want = fleet.ClusterProfile(name=cfg.name, n_nodes=8,
                                power_scale=0.8).scenario()
    assert cfg.survivors == want.survivors
    np.testing.assert_array_equal(cfg.profile.power_table.p_comp,
                                  want.profile.power_table.p_comp)


@requires_cuda
def test_fleet_on_card_rows_equal_standalone():
    """On the card: a mixed fleet's rows equal standalone calls on the
    card, and ``shard=True`` over the visible cards equals the unsharded
    path, bit for bit."""
    skip_without_cuda()
    table = _grid()
    profiles = fleet.synthetic_fleet(24, seed=0)
    kw = dict(n_runs=32, max_failures=16)
    adv = fleet.FleetAdvisor(table, key=KEY, device="cuda", **kw)
    out = adv.advise(profiles)
    sharded = fleet.FleetAdvisor(table, key=KEY, device="cuda", shard=True,
                                 **kw).advise(profiles)
    for c in (0, 7, 23):
        p = profiles[c]
        solo = O.optimize_policy(p.scenario(), KEY, table=table,
                                 process=p.failure_process(), work_s=p.work_s,
                                 device="cuda", **kw)
        _assert_grids_bitwise(out[c].optimum.grid, solo.grid, p.name)
    for a, b in zip(out, sharded):
        _assert_grids_bitwise(b.optimum.grid, a.optimum.grid, a.profile.name)
