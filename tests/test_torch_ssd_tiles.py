"""PyTorch port: the tiling of the bf16 SSD chunk scan at (P, N) = (64, 64)
and (64, 128) (``ssd_wgmma_chunk_scan`` in ``csrc/ssd_scan.cu``), written
out in PyTorch and held to the reference on the CPU.

The kernel cannot run here, so ``_emulate`` repeats the bf16 call's
arithmetic.  Before the chunk scan, ``_chunk_states`` repeats the fused
chunk state (``ssd_wgmma_chunk_state``): per chunk its cum as
``ssd_kernel_chunk_state``'s block scan adds it (``_block_cum``), its local
state ``L = (w x)^T B`` with ``w = exp(cum_end - cum) dt`` split into bf16
hi + lo, then the link: the state entering the chunk split into hi + lo on
the way out (S_in), and ``S <- S exp(cum_end) + L`` in float32, in
``ssd_kernel_state_pass``'s order (``tests/test_torch_ssd_state.py`` holds
it over longer chains and its ticket schedule).  The chunk scan then works
on units of one chunk of one (batch, head): the chunk's steps padded with
zero rows to whole 64-row tiles (a TMA box past Q reads zeros), query
tiles dealt to the two consumer warpgroups by ``ssd.consumer_tiles``;
per query tile q the inter-chunk product on S_in hi + lo, scaled by
``exp2(cum * log2 e)`` (0 past Q), then per key tile j <= q the scores
``C_q B_j^T`` and the decay: on the diagonal tile ``exp2(cum_i - cum_j)
dt_j`` selected where ``j <= i < Q``, below it ``exp2(cum_i - cum_e) w_j``
with ``cum_e`` the key tile's last step and ``w_j = exp2(cum_e - cum_j)
dt_j`` (row factor 0 past Q); G split into bf16 hi (truncated) + lo
(``ssd._split_trunc``), each part times the bf16 x_j.  Rows past Q are
dropped.  The kernel map and the ring come from the
module (``BF16_CHUNK_SCAN``, ``WGMMA_RING``; ``chip_smoke.py`` holds them
equal to the C library's).

Bars: atol 2e-3 / rtol 1e-3 on y and the final state, against the
reference's Pallas kernel in interpret mode (``tests/test_kernels.py``'s
SSD bar) and against the plain version ``ssd_scan_reference``, the bar
the kernel meets on the card.  Chunks 13, 48, 100 and 192 end inside a
64-row tile; two chunks per case exercise the state passed between them.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch.kernels import ssd_scan as ssd

LOG2E = 1.4426950408889634
TILE = 64           # steps of a query or key tile
ATOL, RTOL = 2e-3, 1e-3
WGMMA_PN = tuple(pn for pn, bands in ssd.BF16_CHUNK_SCAN.items()
                 if bands[0][1] == "ssd_wgmma_chunk_scan")

# (chunk, (P, N), groups); batch 1, 4 heads, two chunks
CASES = [(q, pn, g) for q in (13, 48, 100, 192, 256) for pn in WGMMA_PN
         for g in (1, 4)]


def _ids(case):
    q, (p, n), g = case
    return f"chunk{q}-p{p}n{n}-g{g}"


def _split(t, split=ssd._split_bf16):
    return [u.float() for u in split(t)]


def _block_cum(dtc, a, threads: int = 128):
    """cum = the inclusive cumsum of ``dtc * a`` (float32, over the last
    axis) as ``ssd_kernel_chunk_state``'s block scan adds it, which the
    fused kernel keeps: a serial run of ceil(Q / threads) steps per thread,
    an inclusive shuffle scan of the runs within each warp of 32, then the
    totals of the warps before, one at a time."""
    q = dtc.shape[-1]
    per = -(-q // threads)
    la = torch.nn.functional.pad(dtc * a[..., None], (0, threads * per - q))
    la = la.view(*dtc.shape[:-1], threads, per)
    run, parts = torch.zeros(la.shape[:-1]), []
    for m in range(per):
        run = run + la[..., m]
        parts.append(run)
    incl = run.view(*run.shape[:-1], threads // 32, 32)
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        up = torch.nn.functional.pad(incl, (off, 0))[..., :32]
        incl = torch.where(lane >= off, incl + up, incl)
    base = incl.flatten(-2) - run
    warp = torch.arange(threads) // 32
    for w in range(threads // 32 - 1):
        base = torch.where(warp > w, base + incl[..., w, 31, None], base)
    return (torch.stack(parts, -1) + base[..., None]).flatten(-2)[..., :q]


def _chunk_states(x, dt, a, bm, chunk: int):
    """The fused chunk state (``ssd_wgmma_chunk_state``) as it computes
    (module doc).  The kernel runs the units in ticket order, chunks
    slowest: every (batch, head) of chunk c, then of c + 1; here the heads
    of a chunk run at once.  Returns cum (B, H, S), the state entering
    each chunk as a list of its (hi, lo) parts in float32, and the final
    state (B, H, P, N)."""
    b, h, s, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    bank = torch.arange(h) // (h // g)
    xf, dtf, af = x.float(), dt[:, :, 0].float(), a.float()
    bf = bm.float()[:, bank]                                    # (b, h, s, n)
    state = torch.zeros(b, h, p, n)
    cum, s_in = torch.empty(b, h, s), []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dtf[..., sl]
        cum[..., sl] = cc = _block_cum(dtc, af.expand(b, h))
        w = torch.exp(cc[..., -1:] - cc) * dtc
        local = sum(part.transpose(-1, -2) @ bf[:, :, sl]
                    for part in _split(xf[:, :, sl] * w[..., None]))
        # the link: S_c split on the way out, then S_{c+1}
        s_in.append(_split(state))
        state = state * torch.exp(cc[..., -1])[..., None, None] + local
    return cum, s_in, state


def _emulate(x, dt, a, bm, cm, chunk: int):
    """The bf16 call as the kernels compute it (module doc); returns y
    (B, H, S, P) and the final state (B, H, P, N), float32."""
    b, h, s, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    nq = -(-chunk // TILE)
    pad = nq * TILE - chunk
    bank = torch.arange(h) // (h // g)
    xf, dtf = x.float(), dt[:, :, 0].float()
    bf, cf = bm.float()[:, bank], cm.float()[:, bank]           # (b, h, s, n)
    rows = torch.arange(nq * TILE)
    cum_all, s_in, state = _chunk_states(x, dt, a, bm, chunk)
    y = torch.empty(b, h, s, p)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dtf[..., sl]
        cum = cum_all[..., sl]                                      # (b, h, Q)
        s_hi, s_lo = s_in[c0 // chunk]
        # the chunk scan: zero rows past Q, cum in base 2, dt
        zp = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
        xq, bq, cq = zp(xf[:, :, sl]), zp(bf[:, :, sl]), zp(cf[:, :, sl])
        cl2 = torch.nn.functional.pad(cum * LOG2E, (0, pad))
        dtp = torch.nn.functional.pad(dtc, (0, pad))
        yc = torch.zeros(b, h, nq * TILE, p)
        for consumer in ssd.consumer_tiles(nq):
            for q in consumer:
                qi = slice(q * TILE, q * TILE + TILE)
                i = rows[qi]
                acc = cq[:, :, qi] @ s_hi.transpose(-1, -2) \
                    + cq[:, :, qi] @ s_lo.transpose(-1, -2)
                scale = torch.where(i < chunk, torch.exp2(cl2[..., qi]),
                                    torch.zeros(()))
                acc = acc * scale[..., None]
                for j in range(q + 1):
                    kj = slice(j * TILE, j * TILE + TILE)
                    sc = cq[:, :, qi] @ bq[:, :, kj].transpose(-1, -2)
                    if j == q:                  # the diagonal: selected
                        dec = torch.exp2(cl2[..., qi, None] - cl2[..., None, kj]) \
                            * dtp[..., None, kj]
                        keep = (rows[None, kj] <= i[:, None]) & (i[:, None] < chunk)
                        gm = torch.where(keep, sc * dec, torch.zeros(()))
                    else:                       # below it: row x column factors
                        ce = cl2[..., j * TILE + TILE - 1, None]
                        w = torch.exp2(ce - cl2[..., kj]) * dtp[..., kj]
                        r = torch.where(i < chunk, torch.exp2(cl2[..., qi] - ce),
                                        torch.zeros(()))
                        gm = sc * (w[..., None, :] * r[..., :, None])
                    acc = acc + sum(part @ xq[:, :, kj]
                                    for part in _split(gm, ssd._split_trunc))
                yc[:, :, qi] = acc
        y[:, :, sl] = yc[:, :, :chunk]
    return y, state


def _inputs(case):
    """Seeded numpy draws in model layout, x, B and C rounded to bf16."""
    q, (p, n), g = case
    b, h, s = 1, 4, 2 * q
    rng = np.random.default_rng(q * 31 + n + g)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    rnd = lambda v: torch.from_numpy(v).bfloat16().float().numpy()
    return rnd(x), dt, a, rnd(bm), rnd(cm)


def _kernel_layout(x, dt, a, bm, cm):
    lay = lambda v: torch.from_numpy(v).transpose(1, 2).contiguous()
    return (lay(x).bfloat16(), lay(dt)[:, :, None].contiguous(),
            torch.from_numpy(a), lay(bm).bfloat16(), lay(cm).bfloat16())


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_tiles_match_reference_kernel(R, case):
    chunk = case[0]
    arrs = _inputs(case)
    jnp = R.jax.numpy
    y_j, st_j = R.kernel_ops.ssd_scan(*(jnp.asarray(v) for v in arrs),
                                      chunk=chunk)
    y, st = _emulate(*_kernel_layout(*arrs), chunk)
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), np.asarray(y_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_tiles_match_plain_version(case):
    chunk = case[0]
    ops = _kernel_layout(*_inputs(case))
    y_p, st_p = ssd.ssd_scan_reference(*ops, chunk=chunk)
    y, st = _emulate(*ops, chunk)
    assert y.shape == y_p.shape and st.shape == st_p.shape
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), st_p.numpy(), atol=ATOL, rtol=RTOL)


def test_split_rule_computes_each_pair_once():
    """For every chunk 1..256 the two consumers' query tiles cover each
    (query tile, key tile <= query tile) pair of the chunk exactly once,
    and their pair counts differ by at most one query tile's worth (the
    heaviest tile's key tiles)."""
    for chunk in range(1, ssd.WGMMA_MAX_CHUNK + 1):
        nq = -(-chunk // TILE)
        mine = ssd.consumer_tiles(nq)
        pairs = [(q, j) for tiles in mine for q in tiles for j in range(q + 1)]
        assert sorted(pairs) == [(q, j) for q in range(nq) for j in range(q + 1)]
        assert all(list(t) == sorted(set(t)) for t in mine)
        counts = [sum(q + 1 for q in tiles) for tiles in mine]
        assert abs(counts[0] - counts[1]) <= nq, (chunk, mine)
    assert ssd.consumer_tiles(4) == ((0, 3), (1, 2))
    assert ssd.consumer_tiles(3) == ((2,), (0, 1))
    assert ssd.consumer_tiles(1) == ((0,), ())


def test_kernel_map_and_ring_fit_the_card():
    """Every (P, N) has a bf16 chunk-scan kernel for every chunk up to
    MAX_CHUNK; the wgmma kernel serves (64, 64) and (64, 128) up to
    WGMMA_MAX_CHUNK, and its ring (tiles of C, B and x rows, buffers of
    S_in hi and lo, two cum/dt buffers, 1024 bytes of alignment slack)
    fits in a block's 232,448 bytes of shared memory and holds a whole
    chunk's tiles at once (what keeps the ring free of deadlock).  The
    cum/dt/w buffers hold three floats a step."""
    assert set(ssd.BF16_CHUNK_SCAN) == set(ssd.SUPPORTED_PN)
    assert set(WGMMA_PN) == set(ssd.WGMMA_RING) == {(64, 64), (64, 128)}
    for (p, n), bands in ssd.BF16_CHUNK_SCAN.items():
        assert bands[-1] == (ssd.MAX_CHUNK, "ssd_kernel_chunk_scan")
        for chunk in (1, 13, 64, 256, 257, 1024):
            want = "ssd_wgmma_chunk_scan" if (p, n) in WGMMA_PN and \
                chunk <= ssd.WGMMA_MAX_CHUNK else "ssd_kernel_chunk_scan"
            assert ssd.chunk_scan_kernel(p, n, chunk) == want
    for (p, n), (slots, s_bufs) in ssd.WGMMA_RING.items():
        tiles = n // 64                          # 64-column tiles of a row
        tile = (2 * tiles + p // 64) * TILE * 128
        smem = 1024 + slots * tile + s_bufs * 2 * tiles * p * 128 \
            + 2 * 3 * ssd.WGMMA_MAX_CHUNK * 4
        assert smem <= 232_448 - 1024, ((p, n), smem)
        assert slots * TILE >= ssd.WGMMA_MAX_CHUNK and s_bufs >= 1


def test_split_trunc_carries_float32():
    """hi is x truncated to bf16 (an exact bf16, at most one bf16 ulp
    nearer zero than x) and hi + lo recovers x to ~2^-16 of |x|."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 64), np.float32) * 10.0 ** np.arange(-3, 5).repeat(8)[:, None]).float()
    hi, lo = ssd._split_trunc(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float().abs() <= x.abs(), torch.ones_like(x, dtype=torch.bool))
    assert float(((x - hi.float()).abs() / x.abs()).max()) < 2.0 ** -7
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) < 2.0 ** -15


def test_zero_rows_past_q_change_nothing():
    """A chunk of 100 steps computed as two whole 64-row tiles: padding
    with zero rows (what the 4-D tensor map's boxes read past Q) gives the
    same y as the plain version's unpadded chunk, and no NaN from the
    decay of padded rows (selected, never multiplied)."""
    case = (100, (64, 64), 1)
    ops = _kernel_layout(*_inputs(case))
    # a steep decay: exp(cum_i - cum_j) for j > i overflows to inf
    ops = (ops[0], ops[1] * 40.0, *ops[2:])
    y, st = _emulate(*ops, 100)
    y_p, st_p = ssd.ssd_scan_reference(*ops, chunk=100)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), st_p.numpy(), atol=ATOL, rtol=RTOL)
