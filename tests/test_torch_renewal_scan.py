"""PyTorch port: the renewal kernel's plain version against the reference's
Pallas kernel (``interpret=True``) on identical packed inputs.

Both sides take the reference's packed ``(params, nodes, ladder)`` and the
same float32 gaps and felled masks as numpy arrays.  Bars: ``valid`` and the
integer stats exact; the float32 energies and times within 1e-5 relative;
the saving (a difference of two whole-run energies) within 1e-5 of the
reference energy.  The port keeps the rendezvous anchors in float64 where
the reference rounds them to float32 (see kernels/renewal_scan.py), so the
two need not be bit-equal.  Past 4 survivors and 4 ladder levels (the
fleet preset's 7 survivors, 8, 16 with 8 levels, 33 with 5) the same bars
hold on every scenario but the first, whose 1800 s checkpoint interval
puts runs on exact rendezvous wraps: there the reference's float32 anchors
land a period away (ROADMAP.md, Queue 3, item 3), which at 8 levels moves
some level choices, so that scenario is held to the failure and point
counts exactly and to 1e-4 on its floats.  The CUDA kernel itself is held
against this plain version on the card (``requires_cuda``: every survivor
count up to 8 at every ladder depth up to 4, and the shapes beyond up to
the caps, each in every mapping it has; ``chip_smoke.py`` also does it at the
paths' shapes).  On the CPU the dispatch is held here: which kernel and
mappings a shape takes, and that a CPU call runs the plain version.  The kernel's two numerical shortcuts, its fast floor-mod
and its early stop of the zero Kahan steps, are held here against what they
replace through Python twins of the device code.
"""
import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    """The wrapper's bounds are the kernels' compile-time bounds: the exact
    survivor counts and the shallow ladder (FAST_MAX_N/FAST_MAX_F), the
    caps (MAX_N/MAX_F), the group past FAST_MAX_N (GROUP_N, GROUP_LANES) and
    the counts with a register-resident one-lane mapping (THROUGHPUT_MAX_N);
    the caps are unchanged, the old wide kernel is gone, and no kernel
    keeps its survivors in per-thread arrays (local memory)."""
    import pathlib
    import re

    src = (pathlib.Path(rs.__file__).parent / "csrc" / "renewal_scan.cu").read_text()
    bound = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (bound("kMaxN"), bound("kMaxF")) == (rs.FAST_MAX_N, rs.FAST_MAX_F)
    assert (bound("kCapN"), bound("kCapF")) == (rs.MAX_N, rs.MAX_F) == (64, 16)
    assert (bound("kGroupN"), bound("kGroupG")) == (rs.GROUP_N, rs.GROUP_LANES)
    assert bound("kThroughputMaxN") == rs.THROUGHPUT_MAX_N
    assert rs.FAST_MAX_N < rs.GROUP_N < rs.MAX_N
    assert rs.GROUP_N % rs.GROUP_LANES == 0 and 32 % rs.GROUP_LANES == 0
    assert "wide_kernel" not in src and f"{rs.RUN_KERNEL}(" in src
    assert not re.search(r"^\s*(?:float|double|int|bool)\s+\w+\[(?:kCapN|kCapF|\d+)\]",
                         src, re.M)


@pytest.mark.parametrize("n,nf", [(rs.MAX_N + 1, rs.MAX_F),
                                  (rs.MAX_N, rs.MAX_F + 1)])
def test_launch_rejects_shapes_beyond_kernel_bounds(n, nf):
    """Survivors or ladder levels past the kernels' caps raise, naming
    the caps, before anything is built or launched."""
    ops = (torch.zeros(1, rs.N_PARAMS), torch.zeros(1, 3, n),
           torch.zeros(1, 5, nf), torch.ones(K, 8))
    with pytest.raises(ValueError, match=rf"1\.\.{rs.MAX_N} survivors and "
                                         rf"1\.\.{rs.MAX_F} ladder levels"):
        rs._launch_cuda(*ops, None, True)


@pytest.mark.parametrize("n,lanes", [(3, 2), (5, 1), (8, 1), (8, 4), (9, 9),
                                     (9, 16), (17, 8), (33, 33), (64, 16)])
def test_launch_rejects_a_mapping_the_kernel_lacks(n, lanes):
    """A run takes the lanes of one of its shape's mappings (one lane per
    run up to 4 survivors and past 8; one lane per survivor up to 8; a
    group of 8 lanes from 9 to 16); any other count raises before anything
    is built or launched."""
    ops = (torch.zeros(1, rs.N_PARAMS), torch.zeros(1, 3, n),
           torch.zeros(1, 5, 4), torch.ones(K, 8))
    assert lanes not in rs.lane_choices(n)
    with pytest.raises(ValueError, match="lanes per run"):
        rs._launch_cuda(*ops, None, True, lanes=lanes)


# shapes the old wide kernel took: (survivors, levels) -> the mappings'
# lanes per run and kernels
WIDE_DISPATCH = {
    (5, 4): ((5,), ("renewal_scan_kernel<5,5,4>",)),
    (3, 8): ((1, 3), ("renewal_scan_kernel<3,1,16>", "renewal_scan_kernel<3,3,16>")),
    (9, 4): ((1, 8), (rs.RUN_KERNEL, "renewal_scan_kernel<16,8,4>")),
    (17, 5): ((1,), (rs.RUN_KERNEL,)),
    (64, 16): ((1,), (rs.RUN_KERNEL,)),
}


@pytest.mark.parametrize("n,nf", sorted(WIDE_DISPATCH))
def test_wide_kernel_takes_one_lane_per_run(n, nf):
    """The shapes the old wide kernel took (past 4 survivors or 4 levels)
    now take a register kernel, one lane per survivor up to 8 survivors or
    a group of 8 lanes up to 16, or one lane per run (in registers up to 4
    survivors, renewal_scan_run_kernel past 4: the only mapping past 16 and
    the throughput one from 9 to 16); a lane count between raises before
    anything is built or launched."""
    choices, names = WIDE_DISPATCH[n, nf]
    assert rs.lane_choices(n) == choices
    assert tuple(rs.kernel_name(n, nf, g) for g in choices) == names
    assert rs.kernel_name(n, nf) == names[0]
    ops = (torch.zeros(1, rs.N_PARAMS), torch.zeros(1, 3, n),
           torch.zeros(1, 5, nf), torch.ones(K, 8))
    with pytest.raises(ValueError, match="lanes per run"):
        rs._launch_cuda(*ops, None, True, lanes=max(choices) + 1)


def test_kernel_name_follows_the_shape():
    """renewal_scan_kernel<N,G,F>: N the survivor count up to 8, 16 from 9
    to 16; G the lanes per run; F the unrolled ladder; one lane per run
    past 4 survivors is renewal_scan_run_kernel."""
    assert rs.kernel_name(3, 4, 3) == "renewal_scan_kernel<3,3,4>"
    assert rs.kernel_name(4, 4) == "renewal_scan_kernel<4,1,4>"
    assert rs.kernel_name(7, 4, 7) == "renewal_scan_kernel<7,7,4>"
    assert rs.kernel_name(7, 4) == "renewal_scan_kernel<7,7,4>"
    assert rs.kernel_name(3, 5) == "renewal_scan_kernel<3,1,16>"
    assert rs.kernel_name(9, 4, 8) == "renewal_scan_kernel<16,8,4>"
    assert rs.kernel_name(16, 8, 8) == "renewal_scan_kernel<16,8,16>"
    assert rs.kernel_name(9, 4) == rs.kernel_name(33, 8) == rs.RUN_KERNEL
    assert rs.kernel_name(rs.MAX_N, rs.MAX_F) == rs.RUN_KERNEL


# the dispatch at the bounds: (survivors, levels) -> (template survivor
# count of the group or exact kernel, its lanes per run, unrolled ladder;
# whether one lane per run is a mapping)
DISPATCH = {(8, 4): (8, 8, 4, False), (9, 4): (16, 8, 4, True),
            (8, 5): (8, 8, 16, False), (16, 8): (16, 8, 16, True),
            (17, 4): (None, None, None, True), (32, 8): (None, None, None, True),
            (33, 5): (None, None, None, True), (64, 16): (None, None, None, True),
            (9, 16): (16, 8, 16, True), (1, 16): (1, 1, 16, True),
            (4, 5): (4, 4, 16, True), (5, 16): (5, 5, 16, False)}


@pytest.mark.parametrize("n,nf", sorted(DISPATCH))
def test_dispatch_at_the_new_bounds(packed, n, nf):
    """Which kernels and mappings a shape takes at the bounds (4 and 5, 8
    and 9, 16 and 17, 32 and 33, 64 survivors; 4, 5, 8 and 16 levels),
    that every survivor sits in exactly one slot of one lane, and that a
    CPU call runs the plain version (no counted launch, the outputs'
    shapes)."""
    cap, lanes, depth, one_lane = DISPATCH[n, nf]
    choices = rs.lane_choices(n)
    assert (1 in choices) == one_lane
    if cap is None:
        assert choices == (1,)
    else:
        assert lanes in choices and len(choices) == 1 + (one_lane and lanes > 1)
        assert rs.kernel_name(n, nf, lanes) == \
            f"renewal_scan_kernel<{cap},{lanes},{depth}>"
        assert cap % lanes == 0 and lanes <= 32
        slots = {(i % lanes, i // lanes) for i in range(n)}
        assert len(slots) == n and max(s for _, s in slots) < cap // lanes
    if one_lane and n > rs.THROUGHPUT_MAX_N:
        assert rs.kernel_name(n, nf, 1) == rs.RUN_KERNEL
    ops = _with_shape(tuple(torch.from_numpy(a) for a in packed[0]), n, nf)
    gaps = torch.from_numpy(packed[1][:4, :9].copy())
    felled = torch.zeros((4, n, 9))
    before = rs.LAUNCHES["renewal_scan"]
    out = rs.renewal_scan(*ops, gaps, felled)
    assert rs.LAUNCHES["renewal_scan"] == before
    assert tuple(out["valid"].shape) == (6, 4, 9)
    assert all(tuple(out[f].shape) == (6, 9) for f, _ in rs.STAT_FIELDS)
    assert bool(torch.isfinite(out["energy_ref"]).all())


def _widen_ladder(ladder, nf: int):
    """``nf`` ladder levels from a packed (P, 5, F) ladder: the first ``nf``
    levels, or past F levels spaced evenly between the first and the last
    by linear interpolation of every row (level 0 stays the reference)."""
    f = ladder.shape[2]
    if nf <= f:
        return ladder[:, :, :nf]
    lad = np.asarray(to_np(ladder), np.float64)
    pos = np.linspace(0.0, f - 1.0, nf)
    out = np.stack([[np.interp(pos, np.arange(f), row) for row in lane]
                    for lane in lad]).astype(np.float32)
    return torch.as_tensor(out) if isinstance(ladder, torch.Tensor) else out


def _with_shape(ops, n: int, nf: int):
    """Packed operands at ``n`` survivors and ``nf`` ladder levels: node
    columns taken in turn (a fourth survivor repeats the first), ladder
    levels as ``_widen_ladder``."""
    params, nodes, ladder = ops
    cols = [i % nodes.shape[2] for i in range(n)]
    lad = _widen_ladder(ladder, nf)
    if isinstance(nodes, torch.Tensor):
        return (params, nodes[:, :, cols].contiguous(),
                torch.as_tensor(lad).to(ladder.device).contiguous())
    return params, np.ascontiguousarray(nodes[:, :, cols]), \
        np.ascontiguousarray(lad)


@pytest.mark.parametrize("n,nf", [(7, 4), (8, 5), (16, 8), (33, 5)])
def test_plain_version_matches_pallas_wide(ref, packed, n, nf):
    """The plain version at the fleet preset's 7 survivors, at 8 (the last
    exact count) x 5 levels, 16 survivors x 8 levels and 33 (the first
    count past a group of 32) x 5 levels against the reference's Pallas
    kernel in interpret mode, with shocks, at K = 8 and R = 40 (see the
    module docstring for the first scenario's bars)."""
    ops = _with_shape(packed[0], n, nf)
    rng = np.random.default_rng(n)
    gaps = rng.exponential(14 * 24 * 3600.0 / (n + 1), (8, 40)).astype(np.float32)
    felled = (rng.random((8, n, 40)) < 0.2).astype(np.float32)
    theirs = ref.renewal_scan.renewal_scan_pallas(
        *ops, gaps, felled, block_r=32, interpret=True)
    ours = rs.renewal_scan(*(torch.from_numpy(a) for a in ops),
                           torch.from_numpy(gaps), torch.from_numpy(felled))
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    ours = {k: to_np(v) for k, v in ours.items()}
    for name in INT_STATS:
        np.testing.assert_array_equal(ours[name][1:], theirs[name][1:],
                                      err_msg=name)
    for name in ("valid", "n_failures", "truncated", "n_points"):
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    for name in FLOAT_STATS:
        np.testing.assert_allclose(ours[name][1:], theirs[name][1:],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-4,
                                   err_msg=name)
    sav_err = np.abs(ours["saving"].astype(np.float64) - theirs["saving"])
    assert np.all(sav_err[1:] <= 1e-5 * theirs["energy_ref"][1:])
    assert int(ours["valid"].sum()) > 0


WIDE_SHAPES = [(3, 8), (4, 5), (8, 5), (8, 16), (9, 4), (12, 4), (16, 8),
               (17, 5), (32, 8), (33, 4), (33, 8), (48, 8), (rs.MAX_N, 4),
               (rs.MAX_N, rs.MAX_F)]


@requires_cuda
@pytest.mark.parametrize("n,nf", [(n, nf) for n in range(1, rs.FAST_MAX_N + 1)
                                  for nf in range(1, rs.FAST_MAX_F + 1)]
                         + WIDE_SHAPES)
@pytest.mark.parametrize("k,r", [(1, 1), (1, 31), (1, 1000),
                                 (64, 1), (64, 31), (64, 1000)])
def test_cuda_kernel_matches_plain_version(n, nf, k, r):
    """The CUDA kernel against its plain version on the card, on the port's
    own packing of the Table-4 scenarios (no JAX on the GPU machine) cut or
    widened to N survivors and F ladder levels, with and without shocks,
    compensated and not: every output bit-equal, one counted launch per
    call.  R = 1 and 31 leave warps and blocks part-filled.  Both mappings
    of runs to lanes (``lane_choices``) are forced too."""
    skip_without_cuda()
    from repro_torch.core import scenarios, sweep

    dev = torch.device("cuda")
    _, stacked = sweep._renewal_device_inputs(
        list(scenarios.paper_scenarios().values()), torch.float32, dev)
    ops = _with_shape(sweep._pack_kernel_inputs(stacked, MAKESPAN), n, nf)
    rng = np.random.default_rng(0)
    gaps = torch.from_numpy(rng.exponential(
        14 * 24 * 3600.0 / 4, (k, r)).astype(np.float32)).to(dev)
    felled = torch.from_numpy(
        (rng.random((k, n, r)) < 0.2).astype(np.float32)).to(dev)
    for fel in (None, felled):
        for comp in (True, False):
            before = rs.LAUNCHES["renewal_scan"]
            got = rs.renewal_scan(*ops, gaps, fel, compensated=comp)
            want = rs.renewal_scan_reference(*ops, gaps, fel, compensated=comp)
            torch.cuda.synchronize()
            assert rs.LAUNCHES["renewal_scan"] == before + 1
            outs = [got] + [rs._launch_cuda(*ops, gaps, fel, comp, lanes=lanes)
                            for lanes in rs.lane_choices(n)]
            torch.cuda.synchronize()
            for out in outs:
                for name, w in want.items():
                    np.testing.assert_array_equal(to_np(out[name]), to_np(w),
                                                  err_msg=name)


# ---------------------------------------------------------------------------
# the kernel's numerical shortcuts (csrc/renewal_scan.cu), twinned in Python
# ---------------------------------------------------------------------------

def _fma(x: float, y: float, z: float) -> float:
    """x * y + z rounded once to float64, as the device's fma()."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _trunc_rem_twin(a: float, b: float, inv_b: float) -> float:
    """The kernel's trunc_rem: fmod(a, b) from the quotient estimate
    trunc(a * inv_b), one fma and at most one correction of the quotient;
    fmod itself beyond |q| = 2^51, for infinite b and for NaN."""
    x = a * inv_b
    if not abs(x) < 2.0 ** 51 or math.isinf(b):
        return math.fmod(a, b)
    q0 = math.copysign(float(math.trunc(x)), x)
    r0 = _fma(-q0, b, a)
    step = 1.0 if (a >= 0.0) == (b > 0.0) else -1.0
    q_far = r0 < 0.0 if a >= 0.0 else r0 > 0.0
    q_short = not q_far and abs(r0) >= abs(b)
    q = q0 - step if q_far else (q0 + step if q_short else q0)
    r = _fma(-q, b, a)
    return math.copysign(0.0, a) if r == 0.0 else r


def _sign_fix(r: float, b: float) -> float:
    """The kernel's floor_mod on top of a truncated remainder."""
    return r + b if r != 0.0 and ((r < 0.0) != (b < 0.0)) else r


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def _assert_floor_mod_exact(a_values, b: float) -> None:
    """Twin == math.fmod (truncated) and, after the sign fix, == fmod's
    floor-mod and torch.remainder in float64, bit for bit (zeros' signs
    included)."""
    a_values = [float(a) for a in a_values]
    inv_b = 1.0 / b
    torch_rem = torch.remainder(torch.tensor(a_values, dtype=torch.float64),
                                torch.tensor(b, dtype=torch.float64)).tolist()
    for a, want_t in zip(a_values, torch_rem):
        got = _trunc_rem_twin(a, b, inv_b)
        assert _bits(got) == _bits(math.fmod(a, b)), (a, b, got)
        fixed = _sign_fix(got, b)
        assert _bits(fixed) == _bits(_sign_fix(math.fmod(a, b), b)), (a, b)
        assert _bits(fixed) == _bits(want_t), (a, b, fixed, want_t)


# rendezvous periods: the 4 h of the policy grid's workload, one hour, and
# a period that is not a whole number of seconds
PERIODS = (14400.0, 3600.0, float(np.float32(14400.0 / 7.0)))


@pytest.mark.parametrize("b", PERIODS)
def test_fast_floor_mod_exact_multiples_and_their_neighbours(b):
    """a = k * b for k in [-60, 60] (exact zeros, -0.0 for a < 0), and the
    doubles one ulp either side (remainders next to 0 and next to b)."""
    multiples = [k * b for k in range(-60, 61)]
    near = [math.nextafter(a, d) for a in multiples for d in (-math.inf, math.inf)]
    _assert_floor_mod_exact(multiples + near + [-0.0, 0.0], b)


@pytest.mark.parametrize("interval", [2400.0, 4800.0, 9600.0])
def test_fast_floor_mod_commensurate_grid_intervals(interval):
    """The policy grid's commensurate intervals against its 14,400 s
    rendezvous period: anchor - work with work a float32 multiple of the
    checkpoint interval (plus its duration), where the wrap is exactly 0."""
    b = 14400.0
    works = [float(np.float32(j * interval)) for j in range(0, 400)]
    works += [float(np.float32(j * (interval + 120.0))) for j in range(0, 400)]
    a_values = [anchor - w for anchor in (0.0, 7200.0, 14400.0, 12345.5)
                for w in works]
    assert any(math.fmod(a, b) == 0.0 for a in a_values)
    _assert_floor_mod_exact(a_values, b)


def test_fast_floor_mod_falls_back_where_the_quotient_is_inexact():
    """|a / b| >= 2^51 and an infinite b take fmod itself."""
    for a, b in ((1e300, 3.0), (-2.0 ** 60 + 1.0, 7.0), (2.0 ** 52, 0.5),
                 (5.0, math.inf), (-5.0, math.inf)):
        _assert_floor_mod_exact([a], b)


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=-1e8, max_value=1e8),
       st.floats(min_value=1e-3, max_value=1e6))
def test_fast_floor_mod_matches_fmod_sweep(a, b):
    _assert_floor_mod_exact([a], b)


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=-10 ** 6, max_value=10 ** 6),
       st.floats(min_value=1.0, max_value=1e5),
       st.integers(min_value=-3, max_value=3))
def test_fast_floor_mod_near_multiples_sweep(k, b, ulps):
    """a within a few ulp of k * b, where the quotient estimate is most
    likely one off."""
    a = k * b
    for _ in range(abs(ulps)):
        a = math.nextafter(a, math.copysign(math.inf, ulps))
    _assert_floor_mod_exact([a], b)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _bits32(t: torch.Tensor) -> int:
    return int(t.view(torch.int32))


def _kadd_zeros_twin(s, c, steps: int, compensated: bool):
    """The kernel's kadd_zeros: up to ``steps`` zero increments, stopped
    once one leaves the pair bitwise unchanged."""
    zero = _f32(0.0)
    for _ in range(steps):
        s0, c0 = _bits32(s), _bits32(c)
        s, c = rs._kadd(s, c, zero, compensated)
        if _bits32(s) == s0 and _bits32(c) == c0:
            break
    return s, c


def _ledger_pairs():
    """Kahan pairs as a ledger leaves them: running sums of 200 epoch
    energies of widely spread size, stopped at several points."""
    rng = np.random.default_rng(3)
    s, c = _f32(0.0), _f32(0.0)
    pairs = []
    for i, x in enumerate(rng.lognormal(12.0, 3.0, 200).astype(np.float32)):
        s, c = rs._kadd(s, c, _f32(float(x)), True)
        if i % 25 == 24:
            pairs.append((float(s), float(c)))
    return pairs


@pytest.mark.parametrize("compensated", [True, False])
def test_kahan_zero_steps_stop_at_fixed_point(compensated):
    """The early stop gives the (s, c) that all remaining zero increments of
    the plain version's _kadd give, bit for bit: c = -0.0 and +0.0, s = -0.0,
    a c too small to move s, c that moves s for a few steps, and pairs
    taken from a running ledger."""
    pairs = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0),
             (1.0, -0.0), (-2.5e7, 0.0),
             (1.0e6, 1.0e-3), (1.0e6, -1.0e-3),     # |c| below half an ulp of s
             (1.0e6, 0.05), (1.0e6, -0.04),         # c moves s
             (1.0, 0.3), (3.0e-38, 1.0e-45), (-7.0, 1.5e-7)]
    pairs += _ledger_pairs()
    zero = _f32(0.0)
    for s0, c0 in pairs:
        for steps in (0, 1, 2, 3, 7, 64):
            s, c = _f32(s0), _f32(c0)
            for _ in range(steps):
                s, c = rs._kadd(s, c, zero, compensated)
            es, ec = _kadd_zeros_twin(_f32(s0), _f32(c0), steps, compensated)
            assert (_bits32(es), _bits32(ec)) == (_bits32(s), _bits32(c)), \
                (s0, c0, steps)
