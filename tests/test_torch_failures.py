"""PyTorch port: the failure-process axis against the reference.

``LogNormal``, ``Gamma``, ``EmpiricalTrace``, ``stack_processes``,
``renewal_gaps`` and the host statistics (``ks_statistic``, ``ks_critical``,
``fit_weibull``) of ``repro_torch.core.failures`` against
``repro.core.failures``, on numpy-seeded inputs.  Bars:

* ``EmpiricalTrace``: residuals and sampled histories bit-equal (1-D and
  per-node traces: a search and a gather, no special function).
* ``LogNormal`` and ``Gamma`` residuals: within 1e-5 of ``gap + age``
  relative (measured on the CPU: 2.0e-6 LogNormal, 1.5e-6 Gamma at
  k = 0.5, 9.2e-7 at k = 3).  A conditional residual cancels against the
  node's clock age, and the backends' ``erf``/``erfc``/``ndtri`` and
  ``gammaincc`` are not the same code; the Gamma bisection may branch
  differently near its root.  Sampled histories: the failing node equal,
  gaps within the same bar of ``gap +`` the oldest clock's age (the
  reference's replayed ages): each backend carries its own ages, so the
  differences compound over epochs (measured: 3.2e-6 for Gamma k = 0.5,
  where the failing node's own age would give 1.3e-4).
* The LogNormal lower tail: where the survival mass at the node's age is
  below 1e-12 the port's float32 normal CDF stays positive and matches
  the reference's (``torch.special.ndtr`` alone underflows to 0 there).
* Host helpers bit-equal; ``Gamma.survival`` (the reference in float64
  JAX, the port through scipy) within 1e-12 relative.
* Every process drives every renewal engine: the port's host oracle, scan
  and kernel (its plain version here) agree as the engines' bars say, and
  the host oracle's summary is the reference's within 1e-4.
"""
import math

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, to_np

from repro_torch.core import characterization
from repro_torch.core import failures as F
from repro_torch.core import prng, scenarios, sweep

MTBF = 14 * 24 * 3600.0
TOL_RESIDUAL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _pair(ref, family, *args):
    return getattr(F, family).from_mtbf(*args), \
        getattr(ref.failures, family).from_mtbf(*args)


PROCESSES = [("LogNormal", (MTBF, 1.0)), ("LogNormal", (MTBF, [0.5, 1.0, 2.0, 1.0])),
             ("Gamma", (0.5, MTBF)), ("Gamma", (3.0, MTBF)),
             ("Gamma", ([0.5, 1.0, 3.0, 2.0], MTBF))]


def _inputs(seed=0, shape=(2000, 4)):
    rng = np.random.default_rng(seed)
    v = rng.random(shape).astype(np.float32)
    age = (rng.exponential(MTBF, shape)
           * rng.integers(0, 2, shape)).astype(np.float32)
    return v, age


@pytest.mark.parametrize("family,args", PROCESSES)
def test_residual_matches_reference(ref, family, args):
    p_t, p_j = _pair(ref, family, *args)
    for name in ("mu", "sigma", "k", "scale_s"):
        if hasattr(p_t, name):
            np.testing.assert_array_equal(getattr(p_t, name), getattr(p_j, name))
    v, age = _inputs()
    a = to_np(p_t.residual(torch.from_numpy(v), torch.from_numpy(age)))
    b = np.asarray(p_j.residual(v, age))
    assert a.dtype == np.float32 and np.all(np.isfinite(a))
    scale = b.astype(np.float64) + age
    assert np.all(np.abs(a.astype(np.float64) - b) <= TOL_RESIDUAL * scale)
    np.testing.assert_allclose(p_t.mean_s(), p_j.mean_s(), rtol=1e-12)
    assert p_t.label() == p_j.label()


@pytest.mark.parametrize("family,args", PROCESSES[:1] + PROCESSES[2:4])
def test_sampled_histories_match_reference(ref, family, args):
    p_t, p_j = _pair(ref, family, *args)
    g_t, f_t = F.sample_renewal_gaps(p_t, prng.PRNGKey(5), 64, 12, 4,
                                     device="cpu")
    g_j, f_j = ref.failures.sample_renewal_gaps(
        p_j, ref.jax.random.PRNGKey(5), 64, 12, 4)
    g_j, f_j = np.asarray(g_j), np.asarray(f_j)
    np.testing.assert_array_equal(to_np(f_t), f_j)
    oldest = ref.failures.failure_clock_ages(g_j, f_j, 4).max(axis=-1)
    err = np.abs(to_np(g_t).astype(np.float64) - g_j)
    assert np.all(err <= TOL_RESIDUAL * (g_j + oldest))


def test_lognormal_lower_tail_keeps_its_mass(ref):
    """Ages where the survival mass S(age) is below 1e-12: the reference's
    float32 ndtr stays positive (computed through erfc); torch's own ndtr
    underflows to 0 there, and a port that used it would floor u * S(a) at
    1e-37 and land the draw ~13 sigma out.  The port's draws follow the
    reference's within the residual bar."""
    mu, sigma = math.log(1e5), 0.5
    p_t, p_j = F.LogNormal(mu, sigma), ref.failures.LogNormal(mu, sigma)
    z = np.linspace(-12.0, -7.2, 64).astype(np.float32)    # (mu - ln a) / sigma
    age = np.exp(mu - sigma * z.astype(np.float64)).astype(np.float32)
    s_a = p_j.survival(age)
    assert s_a.max() < 1e-12 and s_a.min() > 0.0
    x = torch.from_numpy((mu - np.log(age.astype(np.float64))) / sigma
                         ).to(torch.float32)
    ours = to_np(F._ndtr32(x))
    theirs = np.asarray(ref.jax.scipy.special.ndtr(x.numpy()))
    assert np.all(ours > 0.0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert float(torch.special.ndtr(x).min()) == 0.0       # the hazard
    v = np.linspace(0.01, 0.99, 64).astype(np.float32)
    a = to_np(p_t.residual(torch.from_numpy(v), torch.from_numpy(age)))
    b = np.asarray(p_j.residual(v, age))
    assert np.all(np.isfinite(a))
    assert np.all(np.abs(a.astype(np.float64) - b)
                  <= TOL_RESIDUAL * (b.astype(np.float64) + age))


def test_ndtr_np_and_lognormal_survival(ref):
    x = np.linspace(-30.0, 30.0, 301)
    np.testing.assert_array_equal(F._ndtr_np(x), ref.failures._ndtr_np(x))
    p_t, p_j = _pair(ref, "LogNormal", MTBF, [0.5, 1.0, 2.0, 1.0])
    t = np.array([0.0, 1e3, 1e5, 1e6, 1e8])[:, None]
    np.testing.assert_array_equal(p_t.survival(t), p_j.survival(t))


@pytest.mark.parametrize("k", [0.5, 1.0, 3.0])
def test_gamma_survival_float64(ref, k):
    p_t, p_j = _pair(ref, "Gamma", k, MTBF)
    t = np.geomspace(1.0, 40 * MTBF, 200)
    want = p_j.survival(t)
    got = p_t.survival(t)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def _trace(ref, per_node: bool):
    rng = np.random.default_rng(4)
    shape = (4, 40) if per_node else (50,)
    g = rng.weibull(0.8, shape) * MTBF
    return F.EmpiricalTrace(g), ref.failures.EmpiricalTrace(g)


@pytest.mark.parametrize("per_node", [False, True])
def test_empirical_trace_bit_equal(ref, per_node):
    p_t, p_j = _trace(ref, per_node)
    np.testing.assert_array_equal(p_t.gaps, np.asarray(p_j.gaps))
    v, _ = _inputs(1)
    rng = np.random.default_rng(2)
    # ages below, inside and past each trace (exhausted: unconditional)
    age = (rng.random((2000, 4)) * 1.5 * np.max(p_t.gaps)).astype(np.float32)
    age[::7] = 0.0
    a = to_np(p_t.residual(torch.from_numpy(v), torch.from_numpy(age)))
    b = np.asarray(p_j.residual(v, age))
    np.testing.assert_array_equal(a, b)
    g_t, f_t = F.sample_renewal_gaps(p_t, prng.PRNGKey(6), 48, 10, 4,
                                     device="cpu")
    g_j, f_j = ref.failures.sample_renewal_gaps(
        p_j, ref.jax.random.PRNGKey(6), 48, 10, 4)
    np.testing.assert_array_equal(to_np(g_t), np.asarray(g_j))
    np.testing.assert_array_equal(to_np(f_t), np.asarray(f_j))
    t = np.array([0.0, 1e4, MTBF, 10 * MTBF])[:, None]
    np.testing.assert_array_equal(p_t.survival(t), p_j.survival(t))
    np.testing.assert_array_equal(p_t.mean_s(), p_j.mean_s())
    assert p_t.label() == p_j.label()


def test_empirical_trace_validation():
    for bad in ([5.0], [[1.0, 2.0]] * 0, np.ones((2, 2, 3)), [1.0, -2.0]):
        with pytest.raises(ValueError):
            F.EmpiricalTrace(bad)


def test_renewal_gaps_host_entry_point(ref):
    p_t, p_j = _trace(ref, True)
    g_t, f_t = F.renewal_gaps(p_t, prng.PRNGKey(8), 32, 4, 9, device="cpu")
    g_j, f_j = ref.failures.renewal_gaps(p_j, ref.jax.random.PRNGKey(8), 32, 4, 9)
    assert g_t.dtype == np.float64 and f_t.dtype == np.int64
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(f_t, f_j)


@pytest.mark.parametrize("family,params", [
    ("Weibull", [dict(k=0.7, scale_s=1e5), dict(k=1.3, scale_s=2e5)]),
    ("Gamma", [dict(k=[0.5, 2.0], scale_s=1e5), dict(k=[3.0, 1.0], scale_s=1e4)]),
    ("LogNormal", [dict(mu=11.0, sigma=1.0)]),
    ("EmpiricalTrace", [dict(gaps=[3.0, 1.0, 2.0]), dict(gaps=[5.0, 4.0, 6.0])]),
])
def test_stack_processes_matches_reference(ref, family, params):
    ours = F.stack_processes([getattr(F, family)(**p) for p in params])
    theirs = ref.failures.stack_processes(
        [getattr(ref.failures, family)(**p) for p in params])
    assert type(ours).__name__ == family
    for name in theirs.__dataclass_fields__:
        a, b = getattr(ours, name), np.asarray(getattr(theirs, name))
        assert a.dtype == np.float32 and a.shape[0] == len(params)
        np.testing.assert_array_equal(a, b)


def test_stack_processes_refusals(ref):
    cases = [
        [F.Weibull(0.7, 1e5), F.Gamma(2.0, 1e5)],                 # mixed families
        [F.Weibull([0.7, 0.8], 1e5), F.Weibull([0.7, 0.8, 0.9], 1e5)],
        [F.EmpiricalTrace([1.0, 2.0]), F.EmpiricalTrace([1.0, 2.0, 3.0])],
        [],
    ]
    for procs in cases:
        with pytest.raises(ValueError):
            F.stack_processes(procs)
    with pytest.raises(ValueError):
        ref.failures.stack_processes([ref.failures.Weibull(0.7, 1e5),
                                      ref.failures.Gamma(2.0, 1e5)])


def test_ks_helpers_bit_equal(ref):
    rng = np.random.default_rng(9)
    x = rng.exponential(3.0, 5000)
    cdf = lambda t: 1.0 - np.exp(-np.asarray(t) / 3.1)
    assert F.ks_statistic(x, cdf) == ref.failures.ks_statistic(x, cdf)
    tr = F.EmpiricalTrace(rng.exponential(3.0, 20))
    draws = np.asarray(tr.gaps, np.float64)[rng.integers(0, 20, 4000)]
    assert F.ks_statistic(draws, tr.cdf, discrete=True) == \
        ref.failures.ks_statistic(draws, tr.cdf, discrete=True)
    for n, alpha in ((50_000, 1e-3), (100, 0.05), (7, 0.5)):
        assert F.ks_critical(n, alpha) == ref.failures.ks_critical(n, alpha)


@pytest.mark.parametrize("case", [
    "complete", "censored", "all_censored", "single", "zero_spread",
    "nonpositive_censored_dropped", "short_window"])
def test_fit_weibull_bit_equal(ref, case):
    rng = np.random.default_rng(12)
    x = rng.weibull(0.7, 400) * 5e4
    args = {
        "complete": (x, None),
        "censored": (x[:60], rng.exponential(4e4, 30)),
        "all_censored": ([], [100.0, 250.0, 7.5]),
        "single": ([123.0], None),
        "zero_spread": ([50.0, 50.0, 50.0], [50.0]),
        "nonpositive_censored_dropped": (x[:20], [0.0, -3.0, 1e4]),
        "short_window": (x[:3], rng.exponential(1e6, 12)),
    }[case]
    ours = F.fit_weibull(args[0], censored=args[1])
    theirs = ref.failures.fit_weibull(args[0], censored=args[1])
    assert ours == theirs
    assert all(isinstance(v, float) for v in ours)


def test_fit_weibull_refusals(ref):
    for gaps, censored in (([], None), ([], [0.0, -1.0]), ([1.0, 0.0], None),
                           ([-5.0], [3.0])):
        with pytest.raises(ValueError):
            F.fit_weibull(gaps, censored=censored)
        with pytest.raises(ValueError):
            ref.failures.fit_weibull(gaps, censored=censored)


def test_tpu_v5e_like_profile(ref):
    ours = characterization.tpu_v5e_like_profile()
    theirs = ref.characterization.tpu_v5e_like_profile()
    assert (ours.name, ours.p_base, ours.p_idle_wait) == \
        (theirs.name, theirs.p_base, theirs.p_idle_wait)
    for f in ("freq_ghz", "p_comp", "beta", "p_ckpt", "gamma"):
        np.testing.assert_array_equal(getattr(ours.power_table, f),
                                      getattr(theirs.power_table, f))
    assert dataclasses_equal(ours.sleep, theirs.sleep)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def _processes():
    rng = np.random.default_rng(21)
    trace = rng.weibull(0.8, 64)
    return {
        "lognormal": F.LogNormal.from_mtbf(MTBF, 1.0),
        "gamma": F.Gamma.from_mtbf(0.5, MTBF),
        "trace": F.EmpiricalTrace(trace * MTBF / trace.mean()),
    }


@pytest.mark.parametrize("name", ["lognormal", "gamma", "trace"])
def test_every_process_drives_every_engine(ref, name):
    """The port's three engines on one process's histories: the scan within
    1e-9 of the host oracle and the kernel's plain version within 1e-4,
    counts equal; the host summary within 1e-4 of the reference's host
    summary (whose histories may differ by ulps, see the bars above)."""
    cfg = scenarios.paper_scenarios()["scenario2_long_reexec"]
    proc = _processes()[name]
    kw = dict(n_runs=24, max_failures=10, process=proc, device="cpu")
    host = sweep.renewal_monte_carlo(cfg, prng.PRNGKey(4), engine="host", **kw)
    scan = sweep.renewal_monte_carlo(cfg, prng.PRNGKey(4), engine="device", **kw)
    kern = sweep.renewal_monte_carlo(cfg, prng.PRNGKey(4), engine="kernel", **kw)
    assert host.mean_failures > 0
    for s, tol in ((scan, 1e-9), (kern, 1e-4)):
        assert s.per_node_failures == host.per_node_failures
        assert s.failure_count_hist == host.failure_count_hist
        for f in ("mean_energy_ref_j", "mean_energy_int_j"):
            assert abs(getattr(s, f) / getattr(host, f) - 1) <= tol, (name, f)
        assert abs(s.mean_saving_j - host.mean_saving_j) <= tol * host.mean_energy_ref_j
    p_j = {"lognormal": lambda: ref.failures.LogNormal.from_mtbf(MTBF, 1.0),
           "gamma": lambda: ref.failures.Gamma.from_mtbf(0.5, MTBF),
           "trace": lambda: ref.failures.EmpiricalTrace(proc.gaps)}[name]()
    ref_cfg = ref.scenarios.paper_scenarios()["scenario2_long_reexec"]
    theirs = ref.sweep.renewal_monte_carlo(
        ref_cfg, ref.jax.random.PRNGKey(4), n_runs=24, max_failures=10,
        engine="host", process=p_j)
    assert host.per_node_failures == theirs.per_node_failures
    for f in ("mean_energy_ref_j", "mean_energy_int_j"):
        assert abs(getattr(host, f) / getattr(theirs, f) - 1) <= 1e-4, (name, f)
    assert abs(host.mean_saving_j - theirs.mean_saving_j) \
        <= 1e-4 * theirs.mean_energy_ref_j
    assert host.mtbf_s == theirs.mtbf_s
