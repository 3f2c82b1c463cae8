"""PyTorch port: the kernels' plain oracles in model layout
(``repro_torch.kernels.ref``) and ``kernels.ops``'s ``force_reference=``
against the reference's ``repro.kernels.ref`` on the CPU.

Inputs are numpy draws from a seed, handed to both frameworks.  Bars are
``tests/test_torch_lm_kernels.py``'s: flash attention 2e-5 in float32 and
2e-2 in bfloat16; SSD atol 2e-3 / rtol 1e-3 on y and the final state.
``force_reference=True`` is an explicit request: on a CPU tensor it gives
the oracle's bits and launches nothing; on the card (``requires_cuda``) it
launches nothing either, while the default launches the kernel.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as ssd

FLASH_CASES = [
    # (B, S, T, H, K, D, causal, window, dtype): GQA, a window, suffix
    # queries (S < T), no mask, bfloat16
    (2, 64, 64, 4, 2, 32, True, None, "float32"),
    (1, 96, 96, 4, 1, 64, True, 32, "float32"),
    (1, 32, 80, 4, 2, 16, True, None, "float32"),
    (2, 48, 48, 2, 2, 32, False, None, "float32"),
    (2, 64, 64, 4, 2, 32, True, None, "bfloat16"),
]

SSD_CASES = [
    # (B, S, H, G, P, N, chunk): two groups, one chunk, a chunk > S
    (2, 128, 4, 2, 16, 16, 64),
    (1, 64, 4, 1, 32, 16, 64),
    (2, 48, 2, 1, 16, 32, 256),
]


def _ids(cases):
    return ["-".join(str(v) for v in c) for c in cases]


@pytest.fixture(scope="module")
def R():
    load_reference()
    from repro.kernels import ref

    return ref


def _flash_inputs(b, s, t, h, kh, d, seed=0):
    rng = np.random.default_rng(seed + s + t + d)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32))


def _ssd_inputs(b, s, h, g, p, n, seed=0):
    rng = np.random.default_rng(seed + s + n)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("via", ["ref", "force_reference"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=_ids(FLASH_CASES))
def test_flash_oracle_matches_reference(R, case, via):
    import jax.numpy as jnp

    b, s, t, h, kh, d, causal, win, dtype = case
    arrs = _flash_inputs(b, s, t, h, kh, d)
    want = R.flash_attention_ref(*(jnp.asarray(x).astype(dtype) for x in arrs),
                                 causal=causal, sliding_window=win)
    args = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs]
    fa.reset_launch_counts()
    if via == "ref":
        got = kref.flash_attention_ref(*args, causal=causal,
                                       sliding_window=win)
    else:
        got = ops.flash_attention(*args, causal=causal, sliding_window=win,
                                  force_reference=True)
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("via", ["ref", "force_reference"])
@pytest.mark.parametrize("case", SSD_CASES, ids=_ids(SSD_CASES))
def test_ssd_oracle_matches_reference(R, case, via):
    import jax.numpy as jnp

    b, s, h, g, p, n, chunk = case
    arrs = _ssd_inputs(b, s, h, g, p, n)
    y_j, st_j = R.ssd_scan_ref(*(jnp.asarray(x) for x in arrs),
                               chunk=min(chunk, s))
    args = [torch.from_numpy(x) for x in arrs]
    ssd.reset_launch_counts()
    if via == "ref":
        y, st = kref.ssd_scan_ref(*args, chunk=min(chunk, s))
    else:
        y, st = ops.ssd_scan(*args, chunk=chunk, force_reference=True)
    assert ssd.LAUNCHES == {"ssd_scan": 0}
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), atol=2e-3,
                               rtol=1e-3)


def test_force_reference_is_the_oracle_bit_for_bit():
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(1, 32, 32, 2, 1, 16))
    assert torch.equal(ops.flash_attention(q, k, v, sliding_window=8,
                                           force_reference=True),
                       kref.flash_attention_ref(q, k, v, sliding_window=8))
    arrs = [torch.from_numpy(x) for x in _ssd_inputs(1, 64, 2, 1, 16, 16)]
    got = ops.ssd_scan(*arrs, chunk=32, force_reference=True)
    want = kref.ssd_scan_ref(*arrs, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_force_reference_keeps_the_chunk_rule():
    arrs = [torch.from_numpy(x) for x in _ssd_inputs(1, 48, 2, 1, 16, 16)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(*arrs, chunk=32, force_reference=True)


@requires_cuda
def test_force_reference_launches_nothing_on_card():
    skip_without_cuda()
    q, k, v = (torch.from_numpy(x).cuda()
               for x in _flash_inputs(1, 64, 64, 2, 1, 64))
    arrs = [torch.from_numpy(x).cuda() for x in _ssd_inputs(1, 64, 2, 1, 64, 64)]
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    with torch.no_grad():
        want = ops.flash_attention(q, k, v, force_reference=True)
        y_w, st_w = ops.ssd_scan(*arrs, chunk=32, force_reference=True)
        assert fa.LAUNCHES["flash_attention"] == ssd.LAUNCHES["ssd_scan"] == 0
        got = ops.flash_attention(q, k, v)
        y, st = ops.ssd_scan(*arrs, chunk=32)
    assert fa.LAUNCHES["flash_attention"] == ssd.LAUNCHES["ssd_scan"] == 1
    atol, rtol = fa.PLAIN_TOL[torch.float32]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(y.cpu().numpy(), y_w.cpu().numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(st.cpu().numpy(), st_w.cpu().numpy(),
                               atol=2e-3, rtol=1e-3)
