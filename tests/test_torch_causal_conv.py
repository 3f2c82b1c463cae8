"""PyTorch port: the Mamba2 mixer's causal conv (``kernels/causal_conv.py``,
``kernels.ops.causal_conv``).

On the CPU the entry point runs the plain version, which is the chain the
mixer ran before the kernel, bit for bit, and launches nothing; it refuses
DTensors and operands the kernel cannot take (rank, width, a channel count
no multiple of 8, rows it cannot move 16 bytes at a time) on every device,
and the launching wrapper refuses operands that require grad under grad
mode before it touches a card.

On the card (``requires_cuda``) the kernel is held to the plain version on
the same CUDA operands, laid out as the mixer lays them out (x the xBC
column slice of the in projection's output), by bit-equality: both round
the same float32 products and sums to the model's dtype at the same
points, and both take the SiLU as ``v / (1 + expf(-v))`` in float32 with
CUDA's ``expf``, so no ulp of slack is needed.
"""
import dataclasses
import socket

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from torch_port_ref import requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.configs import zamba2_7b
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, ssm


def _operands(b, s, d_inner, conv, dtype, device="cpu", width=4, extra=8,
              seed=0, zeros=False):
    """x, w, b as ``ssm_mixer`` holds them: x the xBC column slice
    (b, s, conv) of the in projection's (b, s, d_inner + conv + extra)
    output, channels contiguous, rows ``d_inner + conv + extra`` apart.
    ``zeros`` sets every fifth row and every seventh channel of x to 0 and
    makes the weights negative there, so that products of -0 occur."""
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn((b, s, d_inner + conv + extra), generator=gen)
    w = 0.5 * torch.randn((width, conv), generator=gen)
    bias = 0.1 * torch.randn((conv,), generator=gen)
    x = proj[..., d_inner:d_inner + conv]
    if zeros:
        x[:, ::5] = 0.0
        x[..., ::7] = 0.0
        w[:, ::7] = -w[:, ::7].abs()
    proj = proj.to(device, dtype)
    return (proj[..., d_inner:d_inner + conv], w.to(device, dtype),
            bias.to(device, dtype))


def _old_chain(x, w, b):
    """The mixer's conv as it stood before the kernel
    (``models/ssm.py`` ``_causal_conv_local``)."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _widths(cfg):
    d_inner, _, conv = ssm._dims(cfg.d_model, cfg.ssm)
    return d_inner, conv


# ---------------------------------------------------------------------------
# the CPU: the plain version, the mixer and the refusals
# ---------------------------------------------------------------------------

TINY = {"mamba2": tconfigs.get_smoke_config("mamba2-370m"),
        "zamba2-2-groups": zamba2_7b.published_smoke_config()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(TINY))
@pytest.mark.parametrize("seq", [1, 3, 37])
def test_cpu_is_the_old_chain_bit_for_bit(arch, seq, dtype):
    d_inner, conv = _widths(TINY[arch])
    assert conv in (160, 192)
    x, w, b = _operands(2, seq, d_inner, conv, dtype, zeros=True)
    assert not x.is_contiguous() and x.stride(1) == d_inner + conv + 8
    spans.reset_counts()
    got = ops.causal_conv(x, w, b)
    want = _old_chain(x, w, b)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))   # signed zeros too
    assert torch.equal(cc.causal_conv_reference(x, w, b), want)
    assert cc.LAUNCHES == {"causal_conv": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(TINY))
def test_mixer_kernel_path_is_the_plain_path_bit_for_bit(arch, dtype):
    """``ssm_mixer`` with ``use_flash_kernel`` on the CPU (the conv, the SSD
    scan and the gated norm through ``kernels.ops``) gives the mixer's
    plain path bit for bit, on the tiny mamba2 and the two-group published
    Zamba2 layout, over two chunks."""
    cfg = dataclasses.replace(TINY[arch], dtype=str(dtype).split(".")[1])
    gen = torch.Generator().manual_seed(7)
    spec = ssm.ssm_spec(cfg.d_model, cfg.ssm, dtype)
    params = {k: (torch.randn(shape, generator=gen)
                  * (0.3 if isinstance(scale, str) else scale)).to(dt)
              for k, (shape, dt, scale) in spec.items()}
    u = torch.randn((2, 2 * cfg.ssm.chunk_size, cfg.d_model),
                    generator=gen).to(dtype)
    plain = ssm.ssm_mixer(params, u, dataclasses.replace(cfg, use_flash_kernel=False))
    spans.reset_counts()
    kernel = ssm.ssm_mixer(params, u, dataclasses.replace(cfg, use_flash_kernel=True))
    assert kernel.dtype == dtype and torch.equal(kernel, plain)
    assert cc.LAUNCHES == {"causal_conv": 0}


def _bad(what):
    """Operands that break one of the kernel's conditions (``what``)."""
    x, w, b = _operands(2, 9, 128, 160, torch.bfloat16)
    if what == "rank":
        return x[0], w, b
    if what == "width":
        return x, torch.cat([w, w[:1]]), b
    if what == "multiple of 8":
        return x[..., :156], w[:, :156].contiguous(), b[:156].contiguous()
    if what == "16-byte":          # rows 160 + 128 + 3 bf16 apart
        x, w, b = _operands(2, 9, 128, 160, torch.bfloat16, extra=3)
        return x, w, b
    if what == "start":            # x starting one channel in
        proj = torch.zeros((2, 9, 304), dtype=torch.bfloat16)
        return proj[..., 1:161], w, b
    raise AssertionError(what)


@pytest.mark.parametrize("what,match", [
    ("rank", "rank 3"), ("width", "widths"), ("multiple of 8", "multiple of 8"),
    ("16-byte", "16-byte aligned"), ("start", "16-byte aligned")])
def test_operands_the_kernel_cannot_take_raise_on_every_device(what, match):
    x, w, b = _bad(what)
    with pytest.raises(ValueError, match=match):
        ops.causal_conv(x, w, b)
    # the launching wrapper checks the same before it touches a card
    with pytest.raises(ValueError, match=match):
        cc._launch_cuda(x, w, b)
    # the plain path of the mixer takes any of them but the rank
    if what != "rank":
        assert ssm._causal_conv(x, w, b).shape == x.shape


def test_dtypes_that_differ_raise():
    x, w, b = _operands(1, 4, 128, 160, torch.bfloat16)
    with pytest.raises(TypeError, match="alike"):
        ops.causal_conv(x, w.float(), b)
    with pytest.raises(TypeError, match="alike"):
        ops.causal_conv(x.to(torch.float16), w.half(), b.half())


def test_the_launching_wrapper_refuses_grad_before_any_card():
    x, w, b = _operands(1, 6, 128, 160, torch.float32)
    w = w.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cc._launch_cuda(x, w, b)
    # the plain version stays differentiable, as the other kernels' do
    ops.causal_conv(x, w, b).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    # no device type but the CPU's and CUDA's
    with pytest.raises(ValueError, match="unsupported devices"):
        cc.causal_conv(x.to("meta"), w, b)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_dtensors_raise():
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device_type="cpu")
        x, w, b = _operands(1, 4, 128, 160, torch.float32)
        rep = distribute_tensor(x.contiguous(), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="plain"):
            ops.causal_conv(rep, w, b)
        with pytest.raises(TypeError, match="plain"):
            cc._launch_cuda(rep, w, b)
        # the mixer's plain path runs on each rank's own rows and channels
        got = ssm._causal_conv(rep, w, b)
        assert torch.equal(got.full_tensor(), _old_chain(x, w, b))
    finally:
        dist.destroy_process_group()


def test_counts_carries_the_conv_launches():
    assert "causal_conv" in spans.counts()
    spans.reset_counts()
    assert spans.counts()["causal_conv"] == 0 and cc.LAUNCHES["causal_conv"] == 0


@pytest.mark.parametrize("shape,seg", [
    ((16, 4096, 5376, 2), 64),      # mamba2-2.7b's prefill
    ((2, 4096, 7424, 2), 16),       # the published zamba2-7b's
    ((1, 5, 160, 4), 16),           # a tiny float32 config
])
def test_segment_follows_the_shape(shape, seg):
    """Tokens a thread walks: the most of 64, 32, 16 that still gives the
    132 multiprocessors 8 waves of 512 threads."""
    assert cc.segment(*shape, sms=132) == seg


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------

CARD_CASES = [
    # (B, S, d_inner, C, extra, width, dtype, seg): S no multiple of seg, and
    # rows of one batch spanning several segments
    (2, 301, 5120, 5376, 5200, 4, "bfloat16", None),   # mamba2-2.7b's slice
    (3, 257, 7168, 7424, 7280, 4, "bfloat16", None),   # zamba2-7b published
    (2, 301, 5120, 5376, 5200, 4, "bfloat16", 5),
    (3, 257, 7168, 7424, 7280, 4, "bfloat16", 16),
    (2, 130, 7168, 7296, 7280, 4, "bfloat16", 64),     # zamba2 registry
    (1, 70, 2048, 2304, 2080, 4, "float32", 7),        # mamba2-370m
    (2, 41, 128, 160, 8, 3, "float32", 4),             # tiny, width 3
    (2, 41, 128, 192, 8, 2, "bfloat16", 6),            # tiny, width 2
    (1, 2, 128, 160, 8, 4, "bfloat16", None),          # fewer rows than taps
]


def _ids(cases):
    return ["-".join(str(v) for v in c) for c in cases]


@requires_cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids(CARD_CASES))
def test_kernel_is_the_plain_chain_bit_for_bit_on_card(case):
    skip_without_cuda()
    b, s, d_inner, c, extra, width, dtype, seg = case
    dtype = getattr(torch, dtype)
    x, w, bias = _operands(b, s, d_inner, c, dtype, "cuda", width=width,
                           extra=extra, zeros=True)
    assert not x.is_contiguous()
    spans.reset_counts()
    got = cc._launch_cuda(x, w, bias, seg=seg) if seg else ops.causal_conv(x, w, bias)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["causal_conv"] == 1
    want = cc.causal_conv_reference(x, w, bias)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@requires_cuda
def test_the_bar_catches_a_float32_accumulation_on_card():
    """The same taps summed in float32 and rounded once miss the bar the
    kernel meets: bit-equality sees the rounding points."""
    skip_without_cuda()
    x, w, b = _operands(2, 257, 7168, 7424, torch.bfloat16, "cuda",
                        extra=7280)
    once = cc.causal_conv_reference(x.float(), w.float(), b.float()).to(x.dtype)
    assert not torch.equal(once, ops.causal_conv(x, w, b))


@requires_cuda
def test_kernel_refuses_grad_on_card():
    skip_without_cuda()
    x, w, b = _operands(1, 8, 128, 160, torch.float32, "cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.causal_conv(x, w.requires_grad_(True), b)
    with torch.no_grad():
        assert ops.causal_conv(x, w, b).shape == (1, 8, 160)


@requires_cuda
@pytest.mark.parametrize("published", [False, True], ids=["mamba2", "zamba2"])
def test_kernel_path_counts_one_conv_launch_a_layer(published):
    """On the card, a kernel-path prefill of a small SSM config launches the
    conv kernel once a layer, and ``counts()`` reads it."""
    skip_without_cuda()
    cfg = TINY["zamba2-2-groups" if published else "mamba2"]
    model = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    step = tsteps.make_prefill_step(model)
    spans.reset_counts()
    step(params, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert spans.counts()["causal_conv"] == cfg.num_layers
