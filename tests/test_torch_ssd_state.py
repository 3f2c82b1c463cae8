"""PyTorch port: the bf16 SSD scan's fused chunk state at (P, N) = (64, 64)
and (64, 128) (``ssd_wgmma_chunk_state`` in ``csrc/ssd_scan.cu``), its
arithmetic and its schedule, held to the reference on the CPU.

One launch computes, for every chunk of every (batch, head), the chunk's
cum, its local state and, along a chain of flags, the state entering it
(split into bf16 hi + lo for the chunk scan) and the final state.
``test_torch_ssd_tiles._chunk_states`` repeats that arithmetic (cum by
``ssd_kernel_chunk_state``'s block scan, ``L = (w x)^T B`` with w x split
hi + lo, then ``S_in = split(S_c)`` and ``S_{c+1} = S_c exp(cum_end) +
L``) and ``_emulate`` runs the chunk scan after it.  Here every case has
three chunks, so the chain has two links; each link's S_in is held to the
plain version's state after as many chunks.

Units are claimed from a ticket counter, chunks slowest (ticket t is chunk
t // (B H) of head t % (B H)), and a unit's link waits until its head's
flag equals its chunk.  The schedule test simulates blocks that claim and
wait so, in every interleaving drawn, and shows that each unit runs once
and nothing deadlocks, at any number of resident blocks.

Bars: atol 2e-3 / rtol 1e-3 (``tests/test_kernels.py``'s SSD bar) on y,
the final state and each S_in, against the reference's Pallas kernel in
interpret mode and against the plain version ``ssd_scan_reference``.
"""
import numpy as np
import pytest
import torch

from test_torch_ssd_tiles import (ATOL, RTOL, WGMMA_PN, _block_cum,
                                  _chunk_states, _emulate, _kernel_layout)
from torch_port_ref import load_reference

from repro_torch.kernels import ssd_scan as ssd

CHUNKS = 3
# (chunk, (P, N), groups); batch 1, 4 heads, three chunks
CASES = [(q, pn, g) for q in (13, 48, 100, 192, 256) for pn in WGMMA_PN
         for g in (1, 4)]


def _ids(case):
    q, (p, n), g = case
    return f"chunk{q}-p{p}n{n}-g{g}"


def _inputs(case):
    """Seeded numpy draws in model layout, three chunks long; x, B and C
    rounded to bf16."""
    q, (p, n), g = case
    b, h, s = 1, 4, CHUNKS * q
    rng = np.random.default_rng(q * 17 + n + 5 * g)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    rnd = lambda v: torch.from_numpy(v).bfloat16().float().numpy()
    return rnd(x), dt, a, rnd(bm), rnd(cm)


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_fused_state_matches_reference_kernel(R, case):
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
def test_fused_state_matches_plain_version(case):
    """y and the final state, and along the chain the state entering each
    chunk (S_in hi + lo) against the plain version's state after as many
    chunks; chunk 0 enters with zeros."""
    chunk = case[0]
    x, dt, a, bm, cm = ops = _kernel_layout(*_inputs(case))
    y_p, st_p = ssd.ssd_scan_reference(*ops, chunk=chunk)
    y, st = _emulate(*ops, chunk)
    assert y.shape == y_p.shape and st.shape == st_p.shape
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), st_p.numpy(), atol=ATOL, rtol=RTOL)
    _, s_in, last = _chunk_states(x, dt, a, bm, chunk)
    assert torch.equal(last, st) and len(s_in) == CHUNKS
    assert not s_in[0][0].any() and not s_in[0][1].any()
    for c in range(1, CHUNKS):
        end = c * chunk
        _, want = ssd.ssd_scan_reference(x[:, :, :end], dt[..., :end], a,
                                         bm[:, :, :end], cm[:, :, :end],
                                         chunk=chunk)
        hi, lo = s_in[c]
        np.testing.assert_allclose((hi + lo).numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"S_in of chunk {c}")


@pytest.mark.parametrize("q", [1, 13, 100, 128, 129, 192, 256])
def test_block_cum_is_the_cumsum(q):
    """The block scan's sums (the cum scratch the chunk scan reads) are the
    inclusive cumsum of dt * a to float32's rounding: every serial run,
    warp scan and warp total is added, once, in front of the steps it
    precedes."""
    rng = np.random.default_rng(q)
    dtc = torch.from_numpy(np.logaddexp(rng.standard_normal((3, q)), 0)
                           .astype(np.float32))
    a = torch.from_numpy(-np.exp(rng.standard_normal(3) * 0.2).astype(np.float32))
    got = _block_cum(dtc, a).double()
    want = torch.cumsum(dtc.double() * a.double()[:, None], -1)
    scale = torch.cumsum((dtc.double() * a.double()[:, None]).abs(), -1)
    assert float(((got - want).abs() / scale).max()) < 2e-6


def _simulate(n_bh: int, nc: int, blocks: int, depth: int, rng):
    """Resident blocks running the fused kernel's schedule: each claims
    tickets from one counter while it holds fewer than ``depth`` units (a
    block of the kernel holds up to 5: two claimed into its dt buffers, one
    in its consumer, two in its L buffers) and stops at the first ticket
    past the last unit; it links its units in the order it
    claimed them, each once its head's flag equals its chunk, and sets the
    flag to the next chunk.  A random runnable block moves at each step.
    Returns the tickets linked, in order, and the flags, or None where no
    block can move with units left (a deadlock)."""
    n_units = n_bh * nc
    counter, flags, linked = 0, [0] * n_bh, []
    held = [[] for _ in range(blocks)]
    claiming = [True] * blocks
    while len(linked) < n_units:
        moves = []
        for k in range(blocks):
            if claiming[k] and len(held[k]) < depth:
                moves.append((k, None))
            if held[k]:
                c, bh = divmod(held[k][0], n_bh)
                if flags[bh] == c:
                    moves.append((k, bh))
        if not moves:
            return None
        k, bh = moves[rng.integers(len(moves))]
        if bh is None:
            t, counter = counter, counter + 1
            if t < n_units:
                held[k].append(t)
            else:
                claiming[k] = False
        else:
            t = held[k].pop(0)
            assert t % n_bh == bh
            flags[bh] = t // n_bh + 1
            linked.append(t)
    return linked, flags


def test_ticket_schedule_runs_each_unit_once():
    """For every (B H, nc) up to (8, 8), 1 to 16 resident blocks holding
    up to 1, 2 or 5 units each, and drawn interleavings: every unit is
    linked exactly once, chunk after chunk within each head, and no
    schedule deadlocks (a unit's predecessor was claimed B H tickets
    before it, by a block that is running)."""
    rng = np.random.default_rng(25)
    for n_bh in range(1, 9):
        for nc in range(1, 9):
            for blocks in range(1, 17):
                for depth in (1, 2, 5):
                    for _ in range(2):
                        out = _simulate(n_bh, nc, blocks, depth, rng)
                        assert out is not None, (n_bh, nc, blocks, depth)
                        linked, flags = out
                        assert sorted(linked) == list(range(n_bh * nc))
                        assert flags == [nc] * n_bh
                        for bh in range(n_bh):
                            mine = [t // n_bh for t in linked if t % n_bh == bh]
                            assert mine == list(range(nc))


def test_chunk_state_kernel_map():
    """``BF16_CHUNK_STATE`` and ``chunk_state_kernel`` name the fused
    kernel exactly where ``BF16_CHUNK_SCAN`` names the wgmma chunk scan,
    and the two-kernel chunk state elsewhere; the profiler's names map to
    the chunk-state part."""
    assert set(ssd.BF16_CHUNK_STATE) == set(ssd.BF16_CHUNK_SCAN) == \
        set(ssd.SUPPORTED_PN)
    for (p, n), bands in ssd.BF16_CHUNK_STATE.items():
        assert [q for q, _ in bands] == [q for q, _ in ssd.BF16_CHUNK_SCAN[(p, n)]]
        for chunk in (1, 13, 64, 100, 255, 256, 257, 512, 1024):
            scan = ssd.chunk_scan_kernel(p, n, chunk)
            want = "ssd_wgmma_chunk_state" if scan == "ssd_wgmma_chunk_scan" \
                else "ssd_kernel_chunk_state"
            assert ssd.chunk_state_kernel(p, n, chunk) == want, (p, n, chunk)
    assert ssd.KERNEL_NAMES["ssd_wgmma_chunk_state"] == "chunk_state"
    assert ssd.KERNEL_NAMES["ssd_kernel_state_pass"] == "state_pass"


def test_an_older_build_takes_the_local_states_scratch():
    """``_launch_cuda(lib=...)`` asks another build which chunk state it
    runs; a build without ``ssd_scan_bf16_chunk_state`` (one from before
    the fused kernel) runs the two kernels and gets the local states'
    scratch, not the chain's flags."""
    class OlderBuild:
        pass

    assert ssd._fused_state(OlderBuild(), 64, 64, 256) is False
