"""PyTorch port: the Mamba2 mixer's gated norm from the SSD scan's y
(``kernels/gate_norm.py``, ``kernels.ops.gated_norm_skip``).

On the CPU the entry point runs the plain version, which is the chain the
mixer wrote inline, bit for bit, and launches nothing; it refuses DTensors
and group widths or head dims the kernel cannot take, and the launching
wrapper refuses operands that require grad under grad mode, and rows it
cannot move 16 bytes at a time, before it touches a card.  The mixer's kernel path matches the JAX reference's mixer
at ``tests/test_torch_lm.py``'s single-layer bar (1e-5).

On the card (``requires_cuda``) the kernel is held to the plain version on
the same CUDA operands, laid out as the mixer lays them out (y the
transposed view of a (B, H, S, P) float32 buffer, x and z column slices),
at flash's ``PLAIN_TOL``: in bfloat16 one unit in the last place (atol
1e-4 / rtol 1e-2), since both round the same float32 values once and only
the sum of squares is taken in another order; in float32 2e-5.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gate_norm as gn
from repro_torch.kernels import ops
from repro_torch.models import ssm

EPS = 1e-5


def _operands(b, s, h, p, groups, dtype, device="cpu", n=16, pad=0, seed=0):
    """y, x, d, z, w as ``ssm_mixer`` holds them: y the (b,s,h,p) view of a
    (b,h,s,p) float32 buffer, x a column slice of the conv's output
    (b, s, h p + 2 g n [+ pad]) viewed (b,s,h,p), z a column slice of the
    in projection's (b, s, 2 h p + 2 g n + h [+ pad])."""
    gen = torch.Generator().manual_seed(seed)
    d_in = h * p
    conv = d_in + 2 * groups * n + pad
    proj = 2 * d_in + 2 * groups * n + h + pad
    y = torch.randn((b, h, s, p), generator=gen).to(device).transpose(1, 2)
    xbc = torch.randn((b, s, conv), generator=gen).to(device, dtype)
    zx = (2 * torch.randn((b, s, proj), generator=gen)).to(device, dtype)
    d = torch.randn((h,), generator=gen).to(device)
    w = (0.1 * torch.randn((d_in,), generator=gen)).to(device, dtype)
    x = xbc[..., :d_in].reshape(b, s, h, p)
    return y, x, d, zx[..., :d_in], w


def _inline_chain(y, x, d, z, w, groups):
    """The mixer's chain after the scan as it stood before the kernel."""
    b, s, h, p = y.shape
    t = (y + d[:, None] * x.float()).reshape(b, s, h * p).to(z.dtype)
    return ssm.gated_norm(t, z, w, groups, EPS)


# ---------------------------------------------------------------------------
# the CPU: the plain version and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 8, 16, 1), (2, 7, 8, 16, 2),
                                   (1, 5, 6, 64, 3)],
                         ids=["one-group", "two-groups", "three-groups"])
def test_cpu_is_the_inline_chain_bit_for_bit(shape, dtype):
    b, s, h, p, groups = shape
    y, x, d, z, w = _operands(b, s, h, p, groups, dtype)
    spans.reset_counts()
    got = ops.gated_norm_skip(y, x, d, z, w, groups, EPS)
    assert got.dtype == dtype and got.shape == (b, s, h * p)
    assert torch.equal(got, _inline_chain(y, x, d, z, w, groups))
    assert gn.LAUNCHES == {"gate_norm": 0}


@pytest.mark.parametrize("shape,what", [
    ((1, 4, 3, 4, 1), "width 12"),         # 12 channels, one group
    ((1, 4, 4, 6, 1), "head dim 6"),       # width 24, P 6
    ((1, 4, 8, 16, 3), "into 3 groups"),   # 128 channels
])
def test_unsupported_widths_raise_on_every_device(shape, what):
    b, s, h, p, groups = shape
    y, x, d, z, w = _operands(b, s, h, p, 1, torch.float32)
    with pytest.raises(ValueError, match=what):
        ops.gated_norm_skip(y, x, d, z, w, groups, EPS)


def test_shapes_that_do_not_match_raise():
    y, x, d, z, w = _operands(1, 4, 8, 16, 1, torch.float32)
    with pytest.raises(ValueError, match="B, S, H, P"):
        ops.gated_norm_skip(y, x[:, :3], d, z, w, 1, EPS)
    with pytest.raises(ValueError, match="d \\(H,\\)"):
        ops.gated_norm_skip(y, x, d[:4], z, w, 1, EPS)


def test_the_launching_wrapper_refuses_grad_before_any_card():
    y, x, d, z, w = _operands(1, 4, 8, 16, 1, torch.float32)
    w = w.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        gn._launch_cuda(y, x, d, z, w, 1, EPS)
    # the plain version stays differentiable, as the other kernels' do
    ops.gated_norm_skip(y, x, d, z, w, 1, EPS).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    # no device type but the CPU's and CUDA's
    with pytest.raises(ValueError, match="unsupported devices"):
        gn.gate_norm(y.to("meta"), x, d, z, w, groups=1, eps=EPS)


def test_the_launching_wrapper_refuses_misaligned_rows():
    """The kernel moves 16 bytes at a time; rows whose stride is no multiple
    of 16 bytes raise before a card is touched."""
    y, x, d, z, w = _operands(2, 5, 8, 16, 1, torch.bfloat16, pad=3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gn._launch_cuda(y, x, d, z, w, 1, EPS)


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
        y, x, d, z, w = _operands(1, 4, 8, 16, 1, torch.float32)
        rep = distribute_tensor(y.contiguous(), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="plain"):
            ops.gated_norm_skip(rep, x, d, z, w, 1, EPS)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_mixer_kernel_path_matches_reference_mixer(R, arch):
    """``ssm_mixer`` with ``use_flash_kernel`` on the CPU (the plain SSD scan and the
    plain gated norm) against the JAX reference's mixer, on the same
    weights and input: the smoke configs' one-group mixer."""
    jnp = R.jax.numpy
    jcfg = R.configs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    rng = np.random.default_rng(3)
    spec = ssm.ssm_spec(tcfg.d_model, tcfg.ssm, torch.float32)
    params = {k: (rng.standard_normal(shape).astype(np.float32)
                  * (0.5 if scale in ("zeros", "ones") else float(scale)))
              + (1.0 if scale == "ones" else 0.0)
              for k, (shape, _, scale) in spec.items()}
    u = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    spans.reset_counts()
    got = ssm.ssm_mixer({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(u),
                        dataclasses.replace(tcfg, use_flash_kernel=True))
    want = R.models.ssm.ssm_mixer({k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(u), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert gn.LAUNCHES == {"gate_norm": 0}


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------

CARD_CASES = [
    # (B, S, H, P, groups, dtype): S no multiple of the block's 4 tokens
    (2, 301, 80, 64, 1, "bfloat16"),      # mamba2-2.7b: one group of 5120
    (2, 257, 112, 64, 2, "bfloat16"),     # zamba2-7b: two groups of 3584
    (2, 63, 8, 16, 1, "bfloat16"),        # the registry's small configs
    (2, 63, 8, 16, 2, "float32"),
    (1, 130, 112, 64, 2, "float32"),
]


def _ids(cases):
    return ["-".join(str(v) for v in c) for c in cases]


@requires_cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    skip_without_cuda()
    b, s, h, p, groups, dtype = case
    dtype = getattr(torch, dtype)
    y, x, d, z, w = _operands(b, s, h, p, groups, dtype, "cuda")
    assert not y.is_contiguous() and not x.is_contiguous()
    spans.reset_counts()
    got = ops.gated_norm_skip(y, x, d, z, w, groups, EPS)
    torch.cuda.synchronize()
    assert gn.LAUNCHES["gate_norm"] == 1
    want = gn.gate_norm_reference(y, x, d, z, w, groups, EPS)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    atol, rtol = fa.PLAIN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
def test_the_bar_catches_a_wrong_grouping_on_card():
    """One group's norm where the mixer wants two misses the bar the
    kernel meets."""
    skip_without_cuda()
    y, x, d, z, w = _operands(2, 64, 112, 64, 2, torch.bfloat16, "cuda")
    wrong = ops.gated_norm_skip(y, x, d, z, w, 1, EPS)
    want = gn.gate_norm_reference(y, x, d, z, w, 2, EPS)
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    assert not np.allclose(wrong.float().cpu().numpy(),
                           want.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
def test_kernel_refuses_grad_on_card():
    skip_without_cuda()
    y, x, d, z, w = _operands(1, 8, 8, 16, 1, torch.float32, "cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.gated_norm_skip(y, x, d, z, w.requires_grad_(True), 1, EPS)
    with torch.no_grad():
        assert ops.gated_norm_skip(y, x, d, z, w, 1, EPS).shape == (1, 8, 128)


@requires_cuda
def test_grouped_mixer_kernel_path_matches_plain_path_on_card():
    """The published Zamba2 layout's two-group mixer at tiny widths in
    float32: the kernel path (the SSD kernel, then the gated-norm kernel)
    against the plain path, at ``test_torch_lm.py``'s kernel-path bar."""
    skip_without_cuda()
    from repro_torch.configs import zamba2_7b

    cfg = zamba2_7b.published_smoke_config()
    assert cfg.ssm.n_groups == 2
    gen = torch.Generator().manual_seed(5)
    spec = ssm.ssm_spec(cfg.d_model, cfg.ssm, torch.float32)
    params = {k: (torch.randn(shape, generator=gen)
                  * (0.1 if isinstance(scale, str) else scale)).to("cuda", dt)
              for k, (shape, dt, scale) in spec.items()}
    u = torch.randn((2, 256, cfg.d_model), generator=gen).to("cuda")
    spans.reset_counts()
    with torch.no_grad():
        got = ssm.ssm_mixer(params, u,
                            dataclasses.replace(cfg, use_flash_kernel=True))
        want = ssm.ssm_mixer(params, u,
                             dataclasses.replace(cfg, use_flash_kernel=False))
    torch.cuda.synchronize()
    assert gn.LAUNCHES["gate_norm"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-3, rtol=1e-3)
