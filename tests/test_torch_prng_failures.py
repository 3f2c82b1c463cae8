"""PyTorch port: threefry PRNG and failure-gap sampling against jax.random.

Uniform draws and key splits are bit-exact with ``jax.random`` (threefry,
partitionable mode).  Exponential draws are ``-log1p(-u)`` on bit-exact
uniforms; the backends' ``log1p`` differ (XLA's CPU log1p is not correctly
rounded), so they agree within 1 ulp.  The Weibull residual transform
agrees within 4 ulp of its output before the age is subtracted
(``gap + age``: a conditional residual cancels against the node's clock
age).  Sampled histories: the failing node exactly; exponential gaps within
2 ulp (a 1-ulp draw times the MTBF); Weibull gaps within 1e-5 of
``gap + age``, since each backend's recursion carries its own ages and the
ulp differences of ``pow`` compound over epochs.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, to_np

from repro_torch.core import failures as F
from repro_torch.core import prng

SHAPES = [(7,), (3, 5), (64, 16, 4), (33, 129)]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**32 + 5, 2**63 - 1, -1])
def test_prngkey_matches_jax(ref, seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(ref.jax.random.PRNGKey(seed)))


def test_split_matches_jax(ref):
    jr = ref.jax.random
    for num in (2, 5):
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(1), num),
            np.asarray(jr.split(jr.PRNGKey(1), num)))
    # a split key feeds the next split and the draws alike
    k_t = prng.split(prng.PRNGKey(3), 3)[2]
    k_j = jr.split(jr.PRNGKey(3), 3)[2]
    np.testing.assert_array_equal(k_t, np.asarray(k_j))
    np.testing.assert_array_equal(prng.split(k_t, 4), np.asarray(jr.split(k_j, 4)))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_exact(ref, shape):
    jr, jnp = ref.jax.random, ref.jax.numpy
    for key_t, key_j in ((prng.PRNGKey(1), jr.PRNGKey(1)),
                         (prng.split(prng.PRNGKey(9))[1], jr.split(jr.PRNGKey(9))[1])):
        u_t = to_np(prng.uniform(key_t, shape, device="cpu"))
        u_j = np.asarray(jr.uniform(key_j, shape, jnp.float32))
        assert u_t.dtype == np.float32 and u_t.shape == shape
        np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_exponential_within_one_ulp(ref, shape):
    jr, jnp = ref.jax.random, ref.jax.numpy
    e_t = to_np(prng.exponential(prng.PRNGKey(4), shape, device="cpu"))
    e_j = np.asarray(jr.exponential(jr.PRNGKey(4), shape, jnp.float32))
    assert _ulps(e_t, e_j).max() <= 1
    # and it is exactly -log1p(-u) of the bit-exact uniforms
    u_j = torch.from_numpy(np.array(jr.uniform(jr.PRNGKey(4), shape, jnp.float32)))
    np.testing.assert_array_equal(e_t, to_np(-torch.log1p(-u_j)))


@pytest.mark.parametrize("family", ["exponential", "weibull"])
def test_sample_renewal_gaps_matches_reference(ref, family):
    mtbf = 14 * 24 * 3600.0
    if family == "exponential":
        p_t, p_j = F.Exponential(mtbf), ref.failures.Exponential(mtbf)
    else:
        p_t = F.Weibull.from_mtbf([0.7, 0.9, 1.3, 0.7], mtbf)
        p_j = ref.failures.Weibull.from_mtbf([0.7, 0.9, 1.3, 0.7], mtbf)
        np.testing.assert_array_equal(p_t.scale_s, p_j.scale_s)
    g_t, f_t = F.sample_renewal_gaps(p_t, prng.PRNGKey(5), 96, 12, 4,
                                     device="cpu")
    g_j, f_j = ref.failures.sample_renewal_gaps(
        p_j, ref.jax.random.PRNGKey(5), 96, 12, 4)
    assert g_t.dtype == torch.float32 and tuple(g_t.shape) == (96, 12)
    g_j, f_j = np.asarray(g_j), np.asarray(f_j)
    np.testing.assert_array_equal(to_np(f_t), f_j)
    ages = ref.failures.failure_clock_ages(g_j, f_j, 4)        # (R, K, N)
    age_failed = np.take_along_axis(ages, f_j[..., None], -1)[..., 0]
    err = np.abs(to_np(g_t).astype(np.float64) - g_j)
    if family == "exponential":
        assert _ulps(to_np(g_t), g_j).max() <= 2
    else:
        assert np.all(err <= 1e-5 * (g_j + age_failed))


def test_weibull_residual_transform(ref):
    rng = np.random.default_rng(0)
    v = rng.random((2000, 4)).astype(np.float32)
    age = rng.exponential(3e5, (2000, 4)).astype(np.float32)
    k = [0.7, 0.9, 1.3, 0.7]
    p_t = F.Weibull.from_mtbf(k, 14 * 24 * 3600.0)
    p_j = ref.failures.Weibull.from_mtbf(k, 14 * 24 * 3600.0)
    a = to_np(p_t.residual(torch.from_numpy(v), torch.from_numpy(age)))
    b = np.asarray(p_j.residual(v, age))
    ulp = np.spacing((b + age).astype(np.float32))
    assert np.all(np.abs(a.astype(np.float64) - b) <= 4 * ulp)
    e = to_np(F.Exponential(5e4).residual(torch.from_numpy(v), None))
    assert _ulps(e, np.asarray(ref.failures.Exponential(5e4).residual(v, age))).max() <= 4
    np.testing.assert_allclose(p_t.mean_s(), p_j.mean_s(), rtol=1e-12)
    t = np.array([1e3, 1e5, 1e6])
    np.testing.assert_allclose(p_t.survival(t[:, None]),
                               p_j.survival(t[:, None]), rtol=1e-12)


def test_failure_clock_ages_matches_reference(ref):
    g_t, f_t = F.sample_renewal_gaps(F.Weibull(0.8, 3e5), prng.PRNGKey(2), 8,
                                     6, 4, device="cpu")
    np.testing.assert_array_equal(
        F.failure_clock_ages(to_np(g_t), to_np(f_t), 4),
        ref.failures.failure_clock_ages(to_np(g_t), to_np(f_t), 4))


def test_as_process_and_validation():
    assert isinstance(F.as_process(None, 5.0), F.Exponential)
    with pytest.raises(ValueError):
        F.as_process(None)
    with pytest.raises(TypeError):
        F.as_process("weibull")
    with pytest.raises(ValueError):
        F.Weibull(-1.0, 10.0)
