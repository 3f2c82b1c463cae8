"""PyTorch port: the tiling of the bf16 flash kernel at head dims 64, 112
and 128 (``flash_wgmma_kernel`` in ``csrc/flash_attention.cu``), written
out in PyTorch and held to the reference on the CPU.

The kernel cannot run here, so ``_emulate`` repeats its arithmetic: one
block per ``BQ`` = 128 query rows of one (batch, head), the tiles ending
with the 64-row half that holds the last row (``_tiles``), computed as two
64-row halves (the two consumer warpgroups; a half before row 0 does
nothing, rows past Sq read zeros and are dropped); key blocks
of ``BK`` keys visited in order by the visit rule (``_visited``, the TPU
kernel's ``pl.when`` skip over the rows that exist: the tile's for the
ring, each half's for its products); scores scaled by log2 e and
masked per element to ``NEG_INF``; a base-2 online softmax; P split into
bf16 hi + lo (``fa._split_bf16``), each part multiplied by the bf16 V; the
head dim padded with zero columns to the 64-column swizzle atom, as TMA
fills the columns past D; one division and one rounding to bf16 at the
end.  The tiles come from ``fa.BF16_TILES`` (``chip_smoke.py`` holds them
equal to the C library's).  Head dim 16 takes ``flash_mma_kernel`` on the
card; here it shows the padding at its widest (16 of 64 columns).

Bars: against the reference's Pallas kernel in interpret mode the bf16 bar
of ``tests/test_kernels.py`` (2e-2); against the plain version
``PLAIN_TOL`` (atol 1e-4 / rtol 1e-2, one bf16 ulp), the bar the kernel
meets on the card.  Pallas needs lengths that its blocks divide; each case
names blocks that do.
"""
import math

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
WGMMA_DIMS = tuple(d for d, name in fa.BF16_KERNEL.items()
                   if name == "flash_wgmma_kernel")
BQ, BK, STAGES = fa.BF16_TILES[WGMMA_DIMS[0]]
HALF = 64           # rows of one consumer warpgroup
ATOM = 64           # columns of one 128-byte swizzle atom of bf16

# (label, query heads BH, KV heads, Sq, Sk, head dim, window, causal,
#  Pallas block_q, block_k)
CASES = [
    ("causal-d64", 2, 2, 256, 256, 64, None, True, 128, 128),
    ("ragged-d112", 2, 2, 300, 300, 112, None, True, 100, 100),
    ("sq129-d112", 2, 2, 129, 129, 112, None, True, 43, 43),
    ("gqa4-d128", 8, 2, 256, 256, 128, None, True, 128, 128),
    ("padded-d16", 4, 2, 200, 200, 16, None, True, 100, 100),
    ("window-in-tile-d64", 4, 2, 384, 384, 64, 100, True, 128, 128),
    ("window-ragged-d112", 2, 1, 333, 333, 112, 150, True, 111, 111),
    ("suffix-200-of-1000-d64", 4, 2, 200, 1000, 64, None, True, 100, 125),
    ("suffix-window-d128", 4, 2, 200, 1000, 128, 150, True, 100, 125),
    ("offset-not-bk-d112", 4, 2, 100, 300, 112, None, True, 100, 100),
    ("one-query-d128", 2, 1, 1, 300, 128, None, True, 1, 100),
    ("noncausal-d64", 2, 1, 200, 200, 64, None, False, 100, 100),
]


def _visited(r0: int, rows: int, sq: int, sk: int, causal: bool,
             window) -> range:
    """Key blocks the kernel visits for query rows [r0, r0 + rows) (the
    ones that exist: [lo, hi] within [0, Sq)): block j (keys [j BK,
    j BK + BK)) iff it starts inside the keys, no later than row hi's
    position (causal) and, with a window, ends after row lo's window
    begins.  Floor division, as the kernel's ``floor_div``."""
    lo, hi = max(r0, 0), min(r0 + rows, sq) - 1
    if hi < lo:
        return range(0)
    off = sk - sq if causal else 0
    first, last = 0, (sk - 1) // BK
    if causal:
        last = min(last, (hi + off) // BK)
        if window is not None:
            first = max(0, (lo + off - window - BK + 1) // BK + 1)
    return range(first, last + 1)


def _tiles(sq: int) -> list:
    """First rows of the kernel's query tiles, heaviest first: they end
    where the 64-row half holding row Sq - 1 ends, so only the first
    tile's first half can lie before row 0, and then wholly."""
    end = -(-sq // HALF) * HALF
    return [end - (t + 1) * BQ for t in range(-(-sq // BQ))]


def _keep(rows, keys, sq, sk, causal, window):
    """The per-element mask: (len(rows), len(keys)) booleans."""
    qpos = rows[:, None] + (sk - sq if causal else 0)
    keep = np.broadcast_to(keys[None, :] < sk, (len(rows), len(keys))).copy()
    if causal:
        keep &= keys[None, :] <= qpos
        if window is not None:
            keep &= keys[None, :] > qpos - window
    return keep


def _emulate(q, k, v, group: int, causal: bool = True, window=None,
             split: bool = True):
    """The wgmma kernel's arithmetic (module doc), in float32, rounded to
    q's dtype once; ``split=False`` rounds P once to bf16 instead."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dp = -(-d // ATOM) * ATOM
    pad = lambda t, rows: torch.nn.functional.pad(
        t.float(), (0, dp - d, 0, rows - t.shape[1]))
    n_k = -(-sk // BK) * BK
    kv = torch.arange(bh) // group
    kf, vf = pad(k, n_k)[kv], pad(v, n_k)[kv]
    end = -(-sq // HALF) * HALF
    front = -(-sq // BQ) * BQ - end         # rows before row 0, zeros
    qf = torch.nn.functional.pad(pad(q, end), (0, 0, front, 0))
    out = torch.zeros(bh, end + front, dp)
    for q0 in _tiles(sq):
        for r0 in (q0, q0 + HALF):
            blocks = _visited(r0, HALF, sq, sk, causal, window)
            rows = np.arange(r0, r0 + HALF)
            m = torch.full((bh, HALF, 1), fa.NEG_INF)
            l = torch.zeros(bh, HALF, 1)
            o = torch.zeros(bh, HALF, dp)
            for j in blocks:
                keys = np.arange(j * BK, j * BK + BK)
                kt, vt = kf[:, j * BK:j * BK + BK], vf[:, j * BK:j * BK + BK]
                x = (qf[:, front + r0:front + r0 + HALF] @ kt.transpose(1, 2)) * LOG2E
                keep = torch.from_numpy(_keep(rows, keys, sq, sk, causal, window))
                x = x.masked_fill(~keep, fa.NEG_INF)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new)
                l = alpha * l + p.sum(-1, keepdim=True)
                parts = fa._split_bf16(p) if split else (p.bfloat16(),)
                o = o * alpha + sum(part.float() @ vt for part in parts)
                m = m_new
            out[:, front + r0:front + r0 + HALF] = o / l.clamp_min(1e-30)
    return out[:, front:front + sq, :d].to(q.dtype)


def _inputs(case):
    _, bh, kh, sq, sk, d, *_ = case
    rng = np.random.default_rng(sq * 7 + sk + d + bh)
    q = rng.standard_normal((bh, sq, d), np.float32) * d ** -0.5
    k = rng.standard_normal((kh, sk, d), np.float32)
    v = rng.standard_normal((kh, sk, d), np.float32)
    return q, k, v


def _torch_bf16(arrs):
    return [torch.from_numpy(x).bfloat16() for x in arrs]


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tiles_match_reference_kernel(R, case):
    label, bh, kh, sq, sk, d, window, causal, block_q, block_k = case
    arrs = _inputs(case)
    jnp = R.jax.numpy
    want = R.flash_attention.flash_attention_bhsd(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in arrs), group=bh // kh,
        causal=causal, window=window, block_q=block_q, block_k=block_k,
        interpret=True)
    got = _emulate(*_torch_bf16(arrs), bh // kh, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tiles_match_plain_version(case):
    label, bh, kh, sq, sk, d, window, causal, *_ = case
    q, k, v = _torch_bf16(_inputs(case))
    want = fa.flash_attention_reference(q, k, v, group=bh // kh,
                                        causal=causal, window=window)
    got = _emulate(q, k, v, bh // kh, causal, window)
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("window", [None, 1, 37, BK, BK + 1, 300])
def test_visit_rule_is_exact(window):
    """Over every Sq up to 2 BQ + 16 and Sk - Sq in a spread of offsets,
    each query tile's ring carries exactly the key blocks that hold a
    (query, key) pair the mask keeps for one of its rows that exist (none
    skipped that a row needs, none that masks everything for every row),
    and each 64-row half computes exactly those of its own rows: blocks
    of the ring outside its range are masked whole for it, and the two
    ranges cover the ring."""
    checked = 0
    for sq in range(1, 2 * BQ + 17):
        for extra in (0, 1, 63, BK, BK + 1, 300):
            sk = sq + extra
            keys = np.arange(-(-sk // BK) * BK)
            for q0 in _tiles(sq):
                ring = _visited(q0, BQ, sq, sk, True, window)
                halves = []
                for r0, n in ((q0, BQ), (q0, HALF), (q0 + HALF, HALF)):
                    rows = np.arange(max(r0, 0), min(r0 + n, sq))
                    keep = _keep(rows, keys, sq, sk, True, window)
                    needed = np.flatnonzero(keep.reshape(len(rows), -1, BK)
                                            .any(axis=(0, 2))) if len(rows) \
                        else np.zeros(0, int)
                    got = _visited(r0, n, sq, sk, True, window)
                    assert list(got) == needed.tolist(), (sq, sk, r0, n)
                    if n == HALF:
                        assert set(got) <= set(ring)
                        halves.append(set(got))
                assert halves[0] | halves[1] == set(ring), (sq, sk, q0)
                checked += 1
    assert checked > 2000


def test_tiles_cover_every_row_once():
    """The tiles cover rows 0 .. Sq - 1 once; only a whole 64-row half of
    the first tile lies before row 0, and fewer than 64 rows past Sq."""
    for sq in (1, 63, 64, 65, 127, 128, 129, 448, 4000, 4096):
        tiles = _tiles(sq)
        rows = [r for q0 in tiles for r in range(q0, q0 + BQ)]
        assert sorted(r for r in rows if 0 <= r < sq) == list(range(sq))
        assert tiles[-1] in (0, -HALF) and all(q0 > 0 for q0 in tiles[:-1])
        assert 0 <= max(rows) + 1 - sq < HALF


def test_visit_rule_without_causal_visits_every_block():
    for sq, sk in ((1, 1), (129, 300), (256, 1000)):
        for q0 in _tiles(sq):
            assert list(_visited(q0, BQ, sq, sk, False, None)) == \
                list(range(-(-sk // BK)))


def test_bf16_tiles_fit_the_card():
    """Every head dim has a kernel and tiles; the wgmma kernel serves the
    LM paths' head dims (64, 112, 128) with 128-row blocks of two 64-row
    consumers, and its two Q buffers and K/V ring fit in a block's 232,448
    bytes of shared memory with the 1024 bytes that align them."""
    assert set(fa.BF16_TILES) == set(fa.BF16_KERNEL) == set(fa.SUPPORTED_HEAD_DIMS)
    assert set(WGMMA_DIMS) == {64, 112, 128}
    for d in fa.SUPPORTED_HEAD_DIMS:
        bq, bk, stages = fa.BF16_TILES[d]
        assert fa.BF16_KERNEL[d] in fa.KERNEL_NAMES
        if d in WGMMA_DIMS:
            assert (bq, bk, stages) == (BQ, BK, STAGES) and bq == 2 * HALF
            assert bk % 16 == 0 and bk <= 256
            tiles = -(-d // ATOM)
            smem = 1024 + 2 * 2 * tiles * HALF * 128 + stages * 2 * tiles * bk * 128
            assert smem <= 232_448, (d, smem)
        else:
            assert bq == 64 and stages == 2


def test_padding_to_the_swizzle_atom_changes_nothing():
    """Zero columns past D add nothing to Q K^T and give zero output
    columns: the padded emulation at D = 112 equals one at D = 128 whose
    last 16 columns of q, k and v are zero, cut back to 112."""
    case = ("pad", 2, 2, 200, 200, 112, None, True, 100, 100)
    q, k, v = _torch_bf16(_inputs(case))
    wide = [torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v)]
    got = _emulate(q, k, v, 1)
    full = _emulate(*wide, 1)
    assert torch.equal(full[..., 112:], torch.zeros_like(full[..., 112:]))
    assert torch.equal(got, full[..., :112])


def test_rounding_p_once_misses_the_bar():
    """The emulation rounds P once to bf16 in place of the hi/lo split at
    zamba2's head dim and a 2048-token prefill: 3,678 of 229,376 entries
    past PLAIN_TOL, where the split meets it everywhere."""
    case = ("once", 1, 1, 2048, 2048, 112, None, True, 128, 128)
    q, k, v = _torch_bf16(_inputs(case))
    want = fa.flash_attention_reference(q, k, v, group=1)
    once = _emulate(q, k, v, 1, split=False)
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    err = (once.double() - want.double()).abs()
    assert int((err > atol + rtol * want.double().abs()).sum()) > 1000
    twice = _emulate(q, k, v, 1)
    np.testing.assert_allclose(twice.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)
    assert math.isfinite(float(twice.float().abs().max()))
