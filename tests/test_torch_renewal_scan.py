"""PyTorch port: the renewal kernel's plain version against the reference's
Pallas kernel (``interpret=True``) on identical packed inputs.

Both sides take the reference's packed ``(params, nodes, ladder)`` and the
same float32 gaps and felled masks as numpy arrays.  Bars: ``valid`` and the
integer stats exact; the float32 energies and times within 1e-5 relative;
the saving (a difference of two whole-run energies) within 1e-5 of the
reference energy.  The port keeps the rendezvous anchors in float64 where
the reference rounds them to float32 (see kernels/renewal_scan.py), so the
two need not be bit-equal.  The CUDA kernel itself is held against this
plain version on the card (``requires_cuda``; ``chip_smoke.py`` does it at
the main path's shapes).
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda, to_np

from repro_torch.core import energy_model as em
from repro_torch.kernels import renewal_scan as rs

MAKESPAN = 30 * 24 * 3600.0
K, R, BLOCK = 16, 100, 64      # R is not a multiple of the reference's block
FLOAT_STATS = ("energy_ref", "energy_int", "balanced_energy", "end_time")
INT_STATS = ("valid", "n_failures", "truncated", "n_points", "n_sleep",
             "n_min_freq", "n_comp_changed", "n_infeasible")


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def packed(ref):
    """The six Table-4 scenarios packed by the reference, plus histories."""
    jnp = ref.jax.numpy
    cfgs = list(ref.scenarios.paper_scenarios().values())
    _, stacked = ref.sweep._renewal_device_inputs(cfgs, jnp.float32)
    ops = tuple(np.array(a) for a in
                ref.sweep._pack_pallas_inputs(stacked, MAKESPAN))
    rng = np.random.default_rng(0)
    gaps = rng.exponential(14 * 24 * 3600.0 / 4, (K, R)).astype(np.float32)
    felled = (rng.random((K, 3, R)) < 0.2).astype(np.float32)
    return ops, gaps, felled


@pytest.fixture(scope="module")
def outputs(ref, packed):
    """(reference, port) outputs per (felled, compensated) case."""
    ops, gaps, felled = packed
    out = {}
    for use_felled in (False, True):
        for comp in (True, False):
            fel = felled if use_felled else None
            theirs = ref.renewal_scan.renewal_scan_pallas(
                *ops, gaps, fel, block_r=BLOCK, interpret=True,
                compensated=comp)
            ours = rs.renewal_scan(
                *(torch.from_numpy(a) for a in ops), torch.from_numpy(gaps),
                None if fel is None else torch.from_numpy(fel),
                compensated=comp)
            out[use_felled, comp] = ({k: np.asarray(v) for k, v in theirs.items()},
                                     {k: to_np(v) for k, v in ours.items()})
    return out


@pytest.mark.parametrize("use_felled", [False, True])
@pytest.mark.parametrize("compensated", [True, False])
def test_plain_version_matches_pallas(outputs, use_felled, compensated):
    theirs, ours = outputs[use_felled, compensated]
    assert set(ours) == set(theirs)
    for name in INT_STATS:
        assert ours[name].dtype == np.int32
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    for name in FLOAT_STATS:
        assert ours[name].dtype == np.float32
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5,
                                   err_msg=name)
    sav_err = np.abs(ours["saving"].astype(np.float64) - theirs["saving"])
    assert np.all(sav_err <= 1e-5 * theirs["energy_ref"])
    assert ours["valid"].sum() > 0 and np.all(np.isfinite(ours["energy_ref"]))


def test_padded_runs_are_inert(packed):
    """Infinite gaps (the reference's padding sentinel) never occur and
    leave the real runs untouched."""
    ops, gaps, _ = packed
    t = lambda a: torch.from_numpy(a)
    base = rs.renewal_scan(*(t(a) for a in ops), t(gaps))
    padded = np.concatenate([gaps, np.full((K, 28), np.inf, np.float32)], 1)
    out = rs.renewal_scan(*(t(a) for a in ops), t(padded))
    assert int(out["valid"][:, :, R:].sum()) == 0
    assert int(out["n_failures"][:, R:].sum()) == 0
    for name, v in base.items():
        np.testing.assert_array_equal(to_np(out[name])[..., :R], to_np(v),
                                      err_msg=name)
    assert np.all(np.isfinite(to_np(out["energy_ref"])))


def test_pack_lane_params_matches_reference(ref):
    jnp = ref.jax.numpy
    kw = dict(interval=np.array([1800.0, 3600.0]), dur=120.0, reexec0=110.0,
              t_down=60.0, t_restart=60.0, mu1=6.0, mu2=1.0,
              wait_mode=np.array([0, 1]), p_idle_wait=60.0, move_ahead=True,
              move_frac=0.5, makespan=MAKESPAN)
    sl = (25.0, 5.0, 51.0, 91.0, 12.0)
    ours = rs.pack_lane_params(
        sleep=em.SleepArrays(*(np.float32(x) for x in sl)), device="cpu", **kw)
    theirs = ref.renewal_scan.pack_lane_params(
        sleep=ref.energy_model.SleepArrays(*(jnp.float32(x) for x in sl)), **kw)
    np.testing.assert_array_equal(to_np(ours), np.asarray(theirs))
    assert rs.PARAM_COLS == ref.renewal_scan.PARAM_COLS
    assert [n for n, _ in rs.STAT_FIELDS] == [n for n, _ in ref.renewal_scan.STAT_FIELDS]


def test_dispatch_rejects_bad_operands(packed):
    ops, gaps, _ = packed
    t = [torch.from_numpy(a) for a in ops]
    with pytest.raises(ValueError):
        rs.renewal_scan(t[0][:, :5], t[1], t[2], torch.from_numpy(gaps))
    with pytest.raises(TypeError):
        rs.renewal_scan(*ops, gaps)                    # numpy, not tensors
    with pytest.raises(ValueError):
        rs.renewal_scan(*t, torch.from_numpy(gaps), torch.zeros(K, 2, R))
    before = rs.LAUNCHES["renewal_scan"]
    rs.renewal_scan(*t, torch.from_numpy(gaps))        # CPU: plain version
    assert rs.LAUNCHES["renewal_scan"] == before       # counts kernels only


def test_kernel_bounds_match_source():
    """The wrapper's MAX_N/MAX_F are the kernel's compile-time bounds."""
    import pathlib
    import re

    src = (pathlib.Path(rs.__file__).parent / "csrc" / "renewal_scan.cu").read_text()
    bound = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (bound("kMaxN"), bound("kMaxF")) == (rs.MAX_N, rs.MAX_F)


@pytest.mark.parametrize("n,nf", [(rs.MAX_N + 1, rs.MAX_F),
                                  (rs.MAX_N, rs.MAX_F + 1)])
def test_launch_rejects_shapes_beyond_kernel_bounds(n, nf):
    """Survivors or ladder levels past the kernel's register arrays raise
    before anything is built or launched."""
    ops = (torch.zeros(1, rs.N_PARAMS), torch.zeros(1, 3, n),
           torch.zeros(1, 5, nf), torch.ones(K, 8))
    with pytest.raises(ValueError, match="survivors"):
        rs._launch_cuda(*ops, None, True)


@requires_cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, on the port's
    own packing of the Table-4 scenarios (no JAX on the GPU machine): every
    output bit-equal, one counted launch per call."""
    skip_without_cuda()
    from repro_torch.core import scenarios, sweep

    dev = torch.device("cuda")
    _, stacked = sweep._renewal_device_inputs(
        list(scenarios.paper_scenarios().values()), torch.float32, dev)
    ops = sweep._pack_kernel_inputs(stacked, MAKESPAN)
    rng = np.random.default_rng(0)
    gaps = torch.from_numpy(rng.exponential(
        14 * 24 * 3600.0 / 4, (K, 1000)).astype(np.float32)).to(dev)
    felled = torch.from_numpy(
        (rng.random((K, 3, 1000)) < 0.2).astype(np.float32)).to(dev)
    for fel in (None, felled):
        for comp in (True, False):
            before = rs.LAUNCHES["renewal_scan"]
            got = rs.renewal_scan(*ops, gaps, fel, compensated=comp)
            want = rs.renewal_scan_reference(*ops, gaps, fel, compensated=comp)
            torch.cuda.synchronize()
            assert rs.LAUNCHES["renewal_scan"] == before + 1
            for name, w in want.items():
                np.testing.assert_array_equal(to_np(got[name]), to_np(w),
                                              err_msg=name)
