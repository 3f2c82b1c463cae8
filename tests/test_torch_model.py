"""PyTorch port: energy model (eqs. 1-15), planning closed forms and
Algorithm 1 against the reference on seeded numpy inputs.

Bars: discrete fields exact; float64 within 1e-12 relative; float32 within
1e-6 relative (XLA may contract a product and a sum into one FMA, so float32
values can differ by an ulp; the absolute floor is 1e-6 of the array's
scale, for values that cancel to near zero).
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, to_np

from repro_torch.core import characterization as C
from repro_torch.core import energy_model as em
from repro_torch.core import planning
from repro_torch.core import strategies

INTERVAL, DUR = 1800.0, 120.0


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _close(a, b, rtol):
    a, b = np.asarray(to_np(a), np.float64), np.asarray(to_np(b), np.float64)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _inputs(seed=0, t=64, n=3):
    rng = np.random.default_rng(seed)
    age0 = rng.uniform(0.0, INTERVAL, n)
    delta = rng.uniform(0.0, 6 * INTERVAL, (t, 1))
    exec_rem = rng.uniform(1.0, 3600.0, (t, n))
    t_failed = exec_rem + rng.uniform(150.0, 2500.0, (t, n))
    return age0, delta, exec_rem, t_failed


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sawtooth_and_balanced_span(ref, dtype):
    jnp = ref.jax.numpy
    age0, delta, _, _ = _inputs()
    tdt = getattr(torch, dtype)
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    if dtype == "float64":
        r_in, rtol = (age0, delta), 1e-12          # the reference's numpy path
    else:
        r_in, rtol = (jnp.asarray(age0, jnp.float32),
                      jnp.asarray(delta, jnp.float32)), 1e-6
    ours = planning.advance_checkpoint_sawtooth(t(age0), t(delta), INTERVAL, DUR)
    theirs = ref.planning.advance_checkpoint_sawtooth(*r_in, INTERVAL, DUR)
    np.testing.assert_array_equal(to_np(ours[2]), np.asarray(theirs[2]))  # n_fired
    for a, b in zip(ours, theirs):
        assert a.dtype == tdt
        _close(a, b, rtol)
    ours = planning.balanced_span(t(age0), t(delta), INTERVAL, DUR)
    theirs = ref.planning.balanced_span(*r_in, INTERVAL, DUR)
    for a, b in zip(ours, theirs):
        _close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_checkpoint_plan(ref, dtype):
    jnp = ref.jax.numpy
    _, _, exec_rem, t_failed = _inputs(1)
    age = np.random.default_rng(2).uniform(0.0, INTERVAL, exec_rem.shape)
    beta = C.paper_power_table().beta
    tdt = getattr(torch, dtype)
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    if dtype == "float64":
        r = lambda a: a
        rtol = 1e-12
    else:
        r = lambda a: jnp.asarray(a, jnp.float32)
        rtol = 1e-6
    kw = dict(interval=INTERVAL, dur=DUR, move_ahead=True, move_frac=0.5)
    ours = planning.checkpoint_plan(t(exec_rem), t(age), t(t_failed),
                                    beta=t(beta), gamma=None, **kw)
    theirs = ref.planning.checkpoint_plan(r(exec_rem), r(age), r(t_failed),
                                          beta=r(beta), gamma=None, **kw)
    for f in ("n_timer", "n_ckpt", "plan_move"):
        np.testing.assert_array_equal(to_np(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)))
    for f in ("age_at_block_fa", "wait_at_block_fa"):
        _close(getattr(ours, f), getattr(theirs, f), rtol)
    np.testing.assert_array_equal(
        to_np(planning.timer_checkpoint_count(t(exec_rem), t(age), 1.2, INTERVAL)),
        np.asarray(ref.planning.timer_checkpoint_count(
            r(exec_rem), r(age), 1.2, INTERVAL)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_energy_model(ref, dtype):
    jax, jnp = ref.jax, ref.jax.numpy
    _, _, exec_rem, t_failed = _inputs(3)
    n_ckpt = np.random.default_rng(4).integers(0, 3, exec_rem.shape).astype(float)
    wait_mode = np.random.default_rng(5).integers(0, 2, exec_rem.shape)
    prof = C.paper_machine_profile()
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    rtol = 1e-12 if dtype == "float64" else 1e-6
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    lad = em.LadderArrays.from_table(prof.power_table, tdt, "cpu")
    sl = em.SleepArrays.from_spec(prof.sleep, tdt, "cpu")
    with jax.enable_x64(dtype == "float64"):
        r = lambda a: jnp.asarray(a, jdt)
        lad_r = ref.energy_model.LadderArrays.from_table(
            ref.characterization.paper_power_table(), jdt)
        sl_r = ref.energy_model.SleepArrays.from_spec(
            ref.characterization.paper_sleep_spec(), jdt)
        wm = torch.as_tensor(wait_mode, dtype=torch.int32)
        for fn in ("comp_time", "comp_energy"):
            _close(getattr(em, fn)(t(exec_rem), t(n_ckpt), DUR, lad),
                   getattr(ref.energy_model, fn)(r(exec_rem), r(n_ckpt), DUR,
                                                 lad_r), rtol)
        ours = em.intervention_energy(t(exec_rem), t(t_failed), t(n_ckpt), DUR,
                                      lad, sl, wm, 60.0, mu1=6.0, mu2=1.0)
        theirs = ref.energy_model.intervention_energy(
            r(exec_rem), r(t_failed), r(n_ckpt), DUR, lad_r, sl_r,
            jnp.asarray(wait_mode, jnp.int32), 60.0, mu1=6.0, mu2=1.0)
        for k in ("feasible", "sleeps"):
            np.testing.assert_array_equal(to_np(ours[k]), np.asarray(theirs[k]))
        for k in ("total", "comp_t", "wait_t", "e_comp", "e_wait"):
            a, b = to_np(ours[k]), np.asarray(theirs[k])
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin)
            _close(a[fin], b[fin], rtol)
        for lvl in (0, 2):
            _close(em.reference_energy(t(exec_rem), t(t_failed), t(n_ckpt), DUR,
                                       lad, wm, 60.0, ref_level=lvl),
                   ref.energy_model.reference_energy(
                       r(exec_rem), r(t_failed), r(n_ckpt), DUR, lad_r,
                       jnp.asarray(wait_mode, jnp.int32), 60.0,
                       ref_level=lvl), rtol)
        lvl = np.random.default_rng(6).integers(0, 4, exec_rem.shape)
        ct = to_np(em.comp_time(t(exec_rem), t(n_ckpt), DUR, lad))
        want = ct[np.arange(ct.shape[0])[:, None], np.arange(ct.shape[1]), lvl]
        np.testing.assert_array_equal(
            to_np(em.take_level(torch.from_numpy(ct), torch.as_tensor(lvl))), want)
        np.testing.assert_array_equal(np.asarray(ref.energy_model.take_level(
            jnp.asarray(ct), jnp.asarray(lvl))), want)


DECISION_EXACT = ("level", "comp_changed", "wait_action", "feasible_any")
DECISION_FLOAT = ("freq_ghz", "comp_time", "wait_time", "energy_intervened",
                  "energy_reference", "saving")


@pytest.mark.parametrize("form", ["impl", "fold"])
@pytest.mark.parametrize("wait_mode", [0, 1])
def test_algorithm1_matches_reference(ref, form, wait_mode):
    jnp = ref.jax.numpy
    _, _, exec_rem, t_failed = _inputs(7, t=128)
    rng = np.random.default_rng(8)
    n_ckpt = rng.integers(0, 3, exec_rem.shape + (4,)).astype(float)
    # a few nodes with no feasible level exercise the fallback
    t_failed[:4] = exec_rem[:4] * 0.5
    prof = C.paper_machine_profile()
    lad = em.LadderArrays.from_table(prof.power_table, device="cpu")
    sl = em.SleepArrays.from_spec(prof.sleep, device="cpu")
    lad_r = ref.energy_model.LadderArrays.from_table(
        ref.characterization.paper_power_table())
    sl_r = ref.energy_model.SleepArrays.from_spec(
        ref.characterization.paper_sleep_spec())
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    j32 = lambda a: jnp.asarray(a, jnp.float32)
    if form == "impl":
        ours = strategies.evaluate_strategies_impl(
            t32(exec_rem), t32(t_failed), t32(n_ckpt), DUR, lad, sl, wait_mode,
            60.0, mu1=6.0, mu2=1.0, per_level_n_ckpt=True)
        theirs = ref.strategies.evaluate_strategies(
            j32(exec_rem), j32(t_failed), j32(n_ckpt), DUR, lad_r, sl_r,
            wait_mode, 60.0, mu1=6.0, mu2=1.0, per_level_n_ckpt=True)
    else:
        cols = [n_ckpt[..., f] for f in range(4)]
        ours = strategies.evaluate_strategies_fold(
            t32(exec_rem), t32(t_failed), [t32(c) for c in cols], DUR, lad,
            sl, wait_mode, 60.0, mu1=6.0, mu2=1.0)
        theirs = ref.strategies.evaluate_strategies_fold(
            j32(exec_rem), j32(t_failed), [j32(c) for c in cols], DUR, lad_r,
            sl_r, wait_mode, 60.0, mu1=6.0, mu2=1.0)
    assert not bool(ours.feasible_any[:4].any())
    for f in DECISION_EXACT:
        np.testing.assert_array_equal(to_np(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    for f in DECISION_FLOAT:
        _close(getattr(ours, f), getattr(theirs, f), 1e-6)


def test_fold_equals_impl_within_port():
    _, _, exec_rem, t_failed = _inputs(9, t=96)
    n_ckpt = np.random.default_rng(10).integers(0, 3, exec_rem.shape + (4,))
    prof = C.paper_machine_profile()
    lad = em.LadderArrays.from_table(prof.power_table, device="cpu")
    sl = em.SleepArrays.from_spec(prof.sleep, device="cpu")
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    a = strategies.evaluate_strategies_impl(
        t32(exec_rem), t32(t_failed), t32(n_ckpt), DUR, lad, sl, 0, 60.0,
        per_level_n_ckpt=True)
    b = strategies.evaluate_strategies_fold(
        t32(exec_rem), t32(t_failed), [t32(n_ckpt[..., f]) for f in range(4)],
        DUR, lad, sl, 0, 60.0)
    for f in DECISION_EXACT + DECISION_FLOAT:
        np.testing.assert_array_equal(to_np(getattr(a, f)), to_np(getattr(b, f)),
                                      err_msg=f)
