"""PyTorch port: the flash-attention and SSD-scan kernels' plain versions
against the reference's Pallas kernels (interpret mode on the CPU), and the
CUDA kernels against their plain versions on the card (``requires_cuda``).

Inputs are drawn with numpy from a seed and handed to both frameworks;
bfloat16 inputs are the same float32 draws rounded to nearest-even on each
side.  Against the reference, tolerances are ``tests/test_kernels.py``'s:
flash attention 2e-5 in float32 and 2e-2 in bfloat16 (bf16 outputs round
at the 3rd digit); SSD atol 2e-3 / rtol 1e-3 on y and the final state
(float32 cumulative sums of up to 256 log-decays, summed in another
order).  On the card the flash kernel is held to its plain version at the
kernel module's ``PLAIN_TOL`` (in bfloat16 one unit in the last place:
atol 1e-4 / rtol 1e-2), since both round float32 results once.

The bf16 kernels run their products on the tensor cores with bf16
operands; the float32 side of each product (flash's probabilities P, the
SSD's decay-weighted x, entering state and masked scores) is split into two
bf16 parts (``_split_bf16``).  The ``*_split_*`` tests hold that
arithmetic, written in PyTorch, to the same bars at zamba2's widths, and
show that one bf16 rounding instead would not meet them.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch import spans
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gate_norm as gn
from repro_torch.kernels import ops
from repro_torch.kernels import renewal_scan as rs
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.attention import gqa_scores_reference
from repro_torch.models.ssm import ssd_reference

FLASH_CASES = [
    # (B, S, H, K, D, window, dtype) — tests/test_kernels.py FLASH_CASES ...
    (2, 256, 4, 2, 64, None, "float32"),
    (1, 256, 8, 8, 128, None, "float32"),
    (2, 256, 4, 1, 64, 128, "float32"),
    (1, 512, 4, 2, 128, None, "float32"),
    (1, 256, 4, 2, 256, None, "float32"),
    (2, 256, 4, 2, 64, None, "bfloat16"),
    (1, 384, 6, 2, 64, 256, "float32"),
    # ... plus zamba2's head dim, and a ragged length (the reference's
    # wrapper falls back to its oracle there; the port's kernel masks it)
    (1, 256, 4, 4, 112, None, "float32"),
    (2, 200, 4, 2, 64, 64, "float32"),
]

SSD_CASES = [
    # (B, S, H, G, P, N, chunk) — tests/test_kernels.py SSD_CASES ...
    (2, 512, 4, 1, 64, 128, 256),
    (1, 256, 8, 2, 32, 64, 128),
    (1, 512, 4, 4, 64, 64, 128),
    (2, 256, 2, 1, 128, 128, 256),
    # ... plus zamba2's (P, N) and a sequence shorter than the chunk
    (1, 512, 4, 1, 64, 64, 256),
    (2, 48, 8, 1, 16, 16, 256),
]


def _ids(cases):
    return ["-".join(str(v) for v in c) for c in cases]


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _flash_inputs(b, s, h, kh, d, seed=0, sk=None):
    rng = np.random.default_rng(seed + s + h + d)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, sk, kh, d), np.float32),
            rng.standard_normal((b, sk, kh, d), np.float32))


def _ssd_inputs(b, s, h, g, p, n, seed=0):
    rng = np.random.default_rng(seed + s + n)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("case", FLASH_CASES, ids=_ids(FLASH_CASES))
def test_flash_plain_matches_reference_kernel(R, case):
    b, s, h, kh, d, win, dtype = case
    jnp = R.jax.numpy
    arrs = _flash_inputs(b, s, h, kh, d)
    want = R.kernel_ops.flash_attention(
        *(jnp.asarray(x).astype(dtype) for x in arrs), causal=True,
        sliding_window=win)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs),
        causal=True, sliding_window=win)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_suffix_queries_match_reference_kernel(R, window):
    """sq < sk in kernel layout: the queries are the last sq positions
    (q_offset = sk - sq), GQA group 2."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 128, 64), np.float32) * 64 ** -0.5
    k = rng.standard_normal((2, 384, 64), np.float32)
    v = rng.standard_normal((2, 384, 64), np.float32)
    jnp = R.jax.numpy
    want = R.flash_attention.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), group=2, causal=True,
        window=window, interpret=True)
    got = fa.flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), group=2, causal=True,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_plain_matches_model_oracle():
    """The kernel-layout plain version against the port's own einsum oracle
    (-inf masking, model layout) on a ragged GQA + window case."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(2, 100, 6, 2, 32))
    got = ops.flash_attention(q, k, v, causal=True, sliding_window=40)
    want = gqa_scores_reference(q, k, v, causal=True, sliding_window=40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_flash_is_causal():
    """Future keys must not move earlier outputs."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(1, 256, 4, 2, 64))
    out1 = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 100.0
    v2[:, -1] += 100.0
    out2 = ops.flash_attention(q, k2, v2)
    np.testing.assert_allclose(out1[:, :-1].numpy(), out2[:, :-1].numpy(),
                               atol=1e-5)


def _attend(q, k, v, keep, dtype):
    """Masked softmax attention computed in ``dtype``, rounded to bf16."""
    s = (q.to(dtype) @ k.to(dtype).transpose(1, 2)).masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p @ v.to(dtype)) / p.sum(-1, keepdim=True)).bfloat16()


def test_flash_bf16_bar_refuses_a_misplaced_key():
    """``PLAIN_TOL`` in bf16 (one ulp) takes the plain version rounded from
    float64 and refuses outputs that drop one key for late rows or shift
    q_offset by one.  At S = 4096 late rows average ~1500 keys and |out| is
    ~0.03, so an absolute bar of 2e-2 would hardly see such faults."""
    s, d = 4096, 112
    g = torch.Generator().manual_seed(100)
    q = (torch.randn((1, s, d), generator=g) * d ** -0.5).bfloat16()
    k, v = (torch.randn((1, s, d), generator=g).bfloat16() for _ in range(2))
    want = fa.flash_attention_reference(q, k, v, group=1).double()
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    bad = lambda got: int(((got.double() - want).abs()
                           > atol + rtol * want.abs()).sum())
    pos = torch.arange(s)
    causal = pos[None, :] <= pos[:, None]
    assert bad(_attend(q, k, v, causal, torch.float64)) == 0
    dropped = causal.clone()
    dropped[3000:, 2000] = False
    assert bad(_attend(q, k, v, dropped, torch.float32)) > 1000
    shifted = pos[None, :] <= pos[:, None] + 1
    assert bad(_attend(q, k, v, shifted, torch.float32)) > 1000


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids(SSD_CASES))
def test_ssd_plain_matches_reference_kernel(R, case):
    b, s, h, g, p, n, chunk = case
    jnp = R.jax.numpy
    arrs = _ssd_inputs(b, s, h, g, p, n)
    y_j, st_j = R.kernel_ops.ssd_scan(*(jnp.asarray(x) for x in arrs),
                                      chunk=chunk)
    y_t, st_t = ops.ssd_scan(*(torch.from_numpy(x) for x in arrs), chunk=chunk)
    assert y_t.dtype == st_t.dtype == torch.float32
    assert y_t.shape == (b, s, h, p) and st_t.shape == (b, h, p, n)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=2e-3,
                               rtol=1e-3)


def test_ssd_plain_matches_model_oracle():
    """The kernel-layout plain version against the port's chunked oracle
    (model layout), G = 2, two chunks."""
    arrs = [torch.from_numpy(x) for x in _ssd_inputs(2, 128, 4, 2, 16, 16, 5)]
    y, st = ops.ssd_scan(*arrs, chunk=64)
    y_o, st_o = ssd_reference(*arrs, 64)
    np.testing.assert_allclose(y.numpy(), y_o.numpy(), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), st_o.numpy(), atol=2e-3, rtol=1e-3)


def test_ssd_rejects_a_partial_chunk():
    arrs = [torch.from_numpy(x) for x in _ssd_inputs(1, 48, 2, 1, 16, 16)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*arrs, chunk=32)


def test_cpu_calls_launch_no_kernel():
    spans.reset_counts()
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(1, 64, 2, 1, 16))
    ops.flash_attention(q, k, v)
    ops.ssd_scan(*(torch.from_numpy(x) for x in _ssd_inputs(1, 32, 2, 1, 16, 16)),
                 chunk=16)
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert ssd.LAUNCHES == {"ssd_scan": 0}


def _kernel_layout_operands(entry):
    """Small CPU operands of a kernel-layout entry point, its keyword
    arguments and the rest of its ``_launch_cuda`` arguments."""
    if entry == "flash_attention_bhsd":
        q, k, v = (torch.from_numpy(x) for x in _flash_inputs(1, 64, 2, 1, 16))
        ops = (q.reshape(2, 64, 16), k.reshape(1, 64, 16), v.reshape(1, 64, 16))
        return fa, ops, dict(group=2), (2, True, None)
    if entry == "ssd_scan_bhsp":
        x, dt, a, bm, cm = (torch.from_numpy(t) for t in
                            _ssd_inputs(1, 32, 2, 1, 16, 16))
        ops = (x.transpose(1, 2).contiguous(),
               dt.transpose(1, 2)[:, :, None].contiguous(), a,
               bm.transpose(1, 2).contiguous(), cm.transpose(1, 2).contiguous())
        return ssd, ops, dict(chunk=16), (16,)
    if entry == "gate_norm":
        gen = torch.Generator().manual_seed(0)
        ops = (torch.randn(1, 4, 8, 16, generator=gen),
               torch.randn(1, 4, 8, 16, generator=gen),
               torch.randn(8, generator=gen), torch.randn(1, 4, 128, generator=gen),
               torch.randn(128, generator=gen))
        return gn, ops, dict(groups=1, eps=1e-5), (1, 1e-5)
    ops = (torch.zeros(1, rs.N_PARAMS), torch.zeros(1, 3, 2),
           torch.zeros(1, 5, 4), torch.ones(4, 8))
    return rs, ops, {}, (None, True)


KERNEL_LAYOUT = ["flash_attention_bhsd", "ssd_scan_bhsp", "gate_norm",
                 "renewal_scan"]


@pytest.mark.parametrize("entry", KERNEL_LAYOUT)
def test_mixed_devices_raise(entry):
    """Every kernel-layout entry point holds one device rule: an operand on
    another device than the CPU's or CUDA's raises, and so does an operand
    that is no tensor."""
    mod, (*rest, last), kwargs, _ = _kernel_layout_operands(entry)
    fn = getattr(mod, entry)
    with pytest.raises(ValueError, match="unsupported devices"):
        fn(*rest, last.to("meta"), **kwargs)
    with pytest.raises(TypeError, match="torch tensors"):
        fn(*rest, last.numpy(), **kwargs)
    fn(*rest, last, **kwargs)                    # the CPU: the plain version


@pytest.mark.parametrize("entry", KERNEL_LAYOUT)
def test_every_launch_refuses_before_any_card(entry):
    """Each ``_launch_cuda`` makes the same refusals first, before it
    touches a card: an operand that requires grad under grad mode, and
    operands on two devices."""
    mod, (*rest, last), _, args = _kernel_layout_operands(entry)
    with pytest.raises(RuntimeError, match="no backward"):
        mod._launch_cuda(*rest, last.clone().requires_grad_(True), *args)
    with pytest.raises(ValueError, match="one device"):
        mod._launch_cuda(*rest, last.to("meta"), *args)


def test_split_bf16_is_exact_to_float32_class():
    """hi is x rounded to bf16 and hi + lo recovers x to ~2^-16 of |x|."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 64), np.float32) * 10.0 ** np.arange(-3, 5).repeat(8)[:, None])
    hi, lo = fa._split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.bfloat16())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) < 2.0 ** -16


def _flash_pv_bad(split: bool) -> int:
    """Entries beyond ``PLAIN_TOL`` when P.V is formed as the bf16 kernel
    forms it — P in float32, fed to the product split into bf16 hi + lo
    (``split``) or rounded once to bf16 — against the plain version, at
    zamba2's head dim and length (2 heads, 4096 x 112, bf16)."""
    s, d = 4096, 112
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, s, d), np.float32)
                         * d ** -0.5).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, s, d), np.float32)).bfloat16()
            for _ in range(2))
    want = fa.flash_attention_reference(q, k, v, group=1).double()
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    outs = []
    for h in range(2):
        sc = (q[h].float() @ k[h].float().T).masked_fill(~causal, fa.NEG_INF)
        pr = torch.exp(sc - sc.amax(-1, keepdim=True))
        parts = fa._split_bf16(pr) if split else (pr.bfloat16(),)
        num = sum(part.float() @ v[h].float() for part in parts)
        outs.append((num / pr.sum(-1, keepdim=True)).bfloat16())
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    err = (torch.stack(outs).double() - want).abs()
    return int((err > atol + rtol * want.abs()).sum())


def test_flash_split_pv_meets_plain_tol():
    assert _flash_pv_bad(split=True) == 0


def test_flash_single_bf16_pv_misses_plain_tol():
    """Why P is split: one bf16 rounding of P misses one bf16 ulp of the
    output at thousands of entries (8,716 of 917,504 here)."""
    assert _flash_pv_bad(split=False) > 1000


def _ssd_split_bad(split: bool) -> tuple:
    """Entries of (y, final state) beyond atol 2e-3 / rtol 1e-3 when the
    scan is formed as the bf16 kernels form it — per chunk the local state
    (w x)^T B with w = exp(cum_end - cum) dt, the state passed on in
    float32, y = exp(cum) C S_in^T + G x with G = (C B^T) exp(cum_i - cum_j)
    dt_j below the diagonal — with the float32 operand of each product
    (w x, S_in, G) split into bf16 hi + lo (``split``) or rounded once, and
    x, B, C exact bf16.  At zamba2's widths: (1, 8, 4096, 64, 64), chunk
    256, one group."""
    b, h, s, p, n, chunk = 1, 8, 4096, 64, 64, 256
    x, dt, a, bm, cm = _ssd_inputs(b, s, h, 1, p, n, seed=11)
    x = torch.from_numpy(x).transpose(1, 2).contiguous().bfloat16()
    dt = torch.from_numpy(dt).transpose(1, 2)[:, :, None].contiguous()
    a = torch.from_numpy(a)
    bm, cm = (torch.from_numpy(t).transpose(1, 2).contiguous().bfloat16()
              for t in (bm, cm))
    y_p, st_p = ssd.ssd_scan_reference(x, dt, a, bm, cm, chunk=chunk)

    def parts(t):
        return [u.float() for u in (ssd._split_bf16(t) if split else (t.bfloat16(),))]

    xf, dtf, bf, cf = x.float(), dt[:, :, 0], bm.float(), cm.float()
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    state = torch.zeros(b, h, p, n)
    y = torch.empty(b, h, s, p)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dtf[..., sl]
        cum = torch.cumsum(dtc * a[:, None], -1)
        xc, bq, cq = xf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        decay = torch.exp(cum[..., :, None] - cum[..., None, :]) * dtc[..., None, :]
        g = torch.where(tri, (cq @ bq.transpose(-1, -2)) * decay, torch.zeros(()))
        y[:, :, sl] = sum(part @ xc for part in parts(g)) \
            + torch.exp(cum)[..., None] * sum(cq @ part.transpose(-1, -2)
                                              for part in parts(state))
        wx = xc * (torch.exp(cum[..., -1:] - cum) * dtc)[..., None]
        local = sum(part.transpose(-1, -2) @ bq for part in parts(wx))
        state = state * torch.exp(cum[..., -1])[..., None, None] + local
    bad = lambda got, want: int(((got.double() - want.double()).abs()
                                 > 2e-3 + 1e-3 * want.double().abs()).sum())
    return bad(y, y_p), bad(state, st_p)


def test_ssd_split_products_meet_plain_bar():
    assert _ssd_split_bad(split=True) == (0, 0)


def test_ssd_single_bf16_products_miss_plain_bar():
    """Why the float32 operands are split: rounded once to bf16 they miss
    the bar at tens of thousands of y entries (and at entries of the state)."""
    bad_y, bad_state = _ssd_split_bad(split=False)
    assert bad_y > 10000 and bad_state > 0


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

CARD_FLASH_CASES = FLASH_CASES + [
    (2, 4096, 32, 32, 112, None, "bfloat16"),    # zamba2-7b prefill
    (2, 4000, 32, 32, 112, None, "bfloat16"),    # ragged
    (1, 1000, 8, 2, 128, 300, "bfloat16"),
    # the bf16 tensor-core kernel on what only float32 cases reached before
    (2, 256, 4, 1, 64, 128, "bfloat16"),         # GQA + sliding window
    (1, 512, 4, 2, 16, None, "bfloat16"),        # smallest head dim
    (1, 512, 4, 2, 256, None, "bfloat16"),       # largest head dim
    # the wgmma kernel's tile edges (128-row blocks, 128-key ring stages)
    (1, 129, 4, 4, 112, None, "bfloat16"),       # one row past a block
    (1, 384, 4, 1, 64, 100, "bfloat16"),         # window ends inside a block
]
CARD_SSD_CASES = SSD_CASES + [
    (2, 4096, 112, 1, 64, 64, 256),              # zamba2-7b prefill (16 chunks)
    (2, 1024, 8, 4, 64, 64, 256),                # four groups
    (1, 13, 4, 1, 64, 64, 256),                  # chunk 13 (a 13-token prompt)
    (2, 96, 4, 1, 64, 64, 48),                   # chunk 48, not a multiple of 16
    # the wgmma chunk scan's edges, and past its chunks
    (2, 1024, 8, 1, 64, 128, 256),               # mamba2-370m's (P, N)
    (2, 400, 4, 1, 64, 64, 100),                 # chunk 100: a tile ends mid-way
    (1, 768, 8, 4, 64, 128, 192),                # chunk 192, four groups
    (1, 1024, 4, 1, 64, 64, 512),                # chunk 512: the mma.sync scan
    # the fused chunk state's chain: one (batch, head) of 64 chunks (63
    # links one after another), and 3,584 units at chunk 100
    (1, 16384, 1, 1, 64, 64, 256),
    (2, 1600, 112, 1, 64, 64, 100),
]


def _kernel_layout_flash(b, s, h, kh, d, dtype):
    q, k, v = _flash_inputs(b, s, h, kh, d)
    dt = getattr(torch, dtype)
    to = lambda x, n: torch.from_numpy(x).to("cuda", dt).transpose(1, 2) \
        .reshape(b * n, s, d).contiguous()
    return to(q, h) * d ** -0.5, to(k, kh), to(v, kh)


@requires_cuda
@pytest.mark.parametrize("case", CARD_FLASH_CASES, ids=_ids(CARD_FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(case):
    skip_without_cuda()
    b, s, h, kh, d, win, dtype = case
    q, k, v = _kernel_layout_flash(b, s, h, kh, d, dtype)
    spans.reset_counts()
    got = fa.flash_attention_bhsd(q, k, v, group=h // kh, window=win)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    want = fa.flash_attention_reference(q, k, v, group=h // kh, window=win)
    atol, rtol = fa.PLAIN_TOL[q.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
@pytest.mark.parametrize("d", [64, 112])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_kernel_suffix_queries_match_plain_on_card(window, d):
    """bf16 queries that are the last 200 of 1000 keys (q_offset 800, not a
    multiple of the kernel's 128-key blocks), GQA group 2, on the
    tensor-core kernel."""
    skip_without_cuda()
    rng = np.random.default_rng(8)
    to = lambda shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * scale).to("cuda", torch.bfloat16)
    q, k, v = to((4, 200, d), d ** -0.5), to((2, 1000, d)), to((2, 1000, d))
    spans.reset_counts()
    got = fa.flash_attention_bhsd(q, k, v, group=2, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    want = fa.flash_attention_reference(q, k, v, group=2, window=window)
    atol, rtol = fa.PLAIN_TOL[q.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
@pytest.mark.parametrize("case", CARD_SSD_CASES, ids=_ids(CARD_SSD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(case, dtype):
    skip_without_cuda()
    b, s, h, g, p, n, chunk = case
    x, dt_, a, bm, cm = _ssd_inputs(b, s, h, g, p, n)
    lay = lambda v: torch.from_numpy(v).cuda().transpose(1, 2).contiguous()
    x, bm, cm = (lay(v).to(getattr(torch, dtype)) for v in (x, bm, cm))
    dt_ = lay(dt_)[:, :, None, :].contiguous()
    a = torch.from_numpy(a).cuda()
    chunk = min(chunk, s)
    spans.reset_counts()
    y, st = ssd.ssd_scan_bhsp(x, dt_, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == 1
    y_p, st_p = ssd.ssd_scan_reference(x, dt_, a, bm, cm, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(st.cpu().numpy(), st_p.cpu().numpy(), atol=2e-3,
                               rtol=1e-3)
