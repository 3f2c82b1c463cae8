"""PyTorch port: RMSNorm with the ``1 + w`` scale as one CUDA kernel
(``kernels/rms_norm.py``, ``kernels.ops.rms_norm``), the block, final,
shared-block and QK-norms of the LM path when ``use_flash_kernel``.

On the CPU the entry point runs ``layers.rms_norm`` itself, bit for bit,
and launches nothing; it refuses DTensors, widths the kernel cannot take,
rows whose channels are not contiguous and rows it cannot move 16 bytes at
a time, on every device; the launching wrapper refuses operands that
require grad under grad mode before it touches a card.  Each model family
sends exactly its norms through the entry point on the kernel path, and
none on the plain path.

On the card (``requires_cuda``) the kernel is held to the plain version on
the same CUDA operands at flash's ``PLAIN_TOL``: in bfloat16 one unit in the
last place (atol 1e-4 / rtol 1e-2), since both round the same float32
values once and only the sum of squares is taken in another order; in
float32 2e-5.  Each case prints the share of elements that are not
bit-equal.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_port_ref import requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.configs import olmoe_1b_7b, zamba2_7b
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, layers

EPS = 1e-6
DTYPES = [torch.float32, torch.bfloat16]


def _operands(shape, dtype, w_dtype=None, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=gen)).to(device, dtype)
    w = (0.1 * torch.randn((shape[-1],), generator=gen)).to(
        device, w_dtype or dtype)
    return x, w


# ---------------------------------------------------------------------------
# the CPU: the plain version and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_dtype", [None, torch.float32],
                         ids=["w-alike", "w-float32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 136), (2, 3, 2, 48),
                                   (1, 1, 2048)],
                         ids=["2d", "3d", "4d", "decode"])
def test_cpu_is_layers_rms_norm_bit_for_bit(shape, dtype, w_dtype):
    x, w = _operands(shape, dtype, w_dtype)
    spans.reset_counts()
    got = ops.rms_norm(x, w, EPS)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, layers.rms_norm(x, w, EPS))
    assert rn.LAUNCHES == {"rms_norm": 0}


def test_cpu_takes_a_row_stride():
    """A column slice whose row stride is a multiple of 16 bytes is taken,
    as the kernel takes it, and the plain version runs on it as it is."""
    base, w = _operands((2, 6, 96), torch.float32)
    x = base[..., 8:72]
    w = w[:64].clone()
    assert not x.is_contiguous()
    assert torch.equal(ops.rms_norm(x, w, EPS), layers.rms_norm(x, w, EPS))


@pytest.mark.parametrize("width,what", [(12, "multiple of 8"),
                                        (4, "multiple of 8"),
                                        (rn.MAX_WIDTH + 8, "up to 16384")])
def test_widths_the_kernel_cannot_take_raise_on_every_device(width, what):
    x, w = _operands((3, width), torch.float32)
    with pytest.raises(ValueError, match=what):
        ops.rms_norm(x, w, EPS)


def test_shapes_and_dtypes_that_do_not_match_raise():
    x, w = _operands((3, 64), torch.float32)
    with pytest.raises(ValueError, match="w \\(D,\\)"):
        ops.rms_norm(x, w[:32], EPS)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.rms_norm(x.half(), w, EPS)


@pytest.mark.parametrize("case", ["row-stride", "pointer", "channels"])
def test_rows_it_cannot_move_raise_on_every_device(case):
    """A row stride or a pointer no multiple of 16 bytes, or channels that
    are not contiguous, raise on the CPU as on a card, and the launching
    wrapper refuses them before a card is touched."""
    if case == "row-stride":
        base, _ = _operands((4, 68), torch.bfloat16)       # 136-byte rows
        x, what = base[:, :64], "16-byte aligned"
        w = _operands((64,), torch.bfloat16)[1]
    elif case == "pointer":
        base, w = _operands((4 * 64 + 1,), torch.float32)
        x, what = base[1:].view(4, 64), "16-byte aligned"
        w = w[:64].clone()
    else:
        base, w = _operands((64, 4), torch.float32)
        x, what = base.t(), "contiguous channels"
        w = w.new_zeros(64)
    with pytest.raises(ValueError, match=what):
        ops.rms_norm(x, w, EPS)
    with pytest.raises(ValueError, match=what):
        rn._launch_cuda(x, w, EPS)


def test_the_launching_wrapper_refuses_grad_before_any_card():
    x, w = _operands((3, 64), torch.float32)
    w = w.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        rn._launch_cuda(x, w, EPS)
    # the plain version stays differentiable, as the other kernels' do
    ops.rms_norm(x, w, EPS).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    # no device type but the CPU's and CUDA's
    with pytest.raises(ValueError, match="unsupported devices"):
        rn.rms_norm(x.to("meta"), w, EPS)


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
        x, w = _operands((3, 64), torch.float32)
        rep = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="plain"):
            ops.rms_norm(rep, w, EPS)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the models: which norms go through the entry point
# ---------------------------------------------------------------------------

def _family(name: str):
    """(config, the norm calls of one prefill) of each family's small
    layout: the ssm decoder a block norm a layer and the final norm; the
    published hybrid one a Mamba layer, two a shared-block call and the
    final; the published OLMoE two block norms and the q and k norms a
    layer and the final."""
    if name == "mamba2":
        cfg = tconfigs.get_smoke_config("mamba2-370m")
        return cfg, cfg.num_layers + 1
    if name == "zamba2-published":
        cfg = zamba2_7b.published_smoke_config()
        return cfg, cfg.num_layers + 2 * len(cfg.hybrid.layer_ids) + 1
    cfg = olmoe_1b_7b.published_smoke_config()
    return cfg, 4 * cfg.num_layers + 1


FAMILIES = ["mamba2", "zamba2-published", "olmoe-published"]


@pytest.mark.parametrize("kernel_path", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("family", FAMILIES)
def test_models_send_their_norms_through_the_entry_point(family, kernel_path,
                                                         monkeypatch):
    """On the CPU a prefill on the kernel path calls ``kernels.rms_norm``
    once for each norm of the model; the plain path calls it never."""
    cfg, calls = _family(family)
    cfg = dataclasses.replace(cfg, use_flash_kernel=kernel_path)
    seen = []
    real = rn.rms_norm

    def counting(x, w, eps):
        seen.append(x.shape[-1])
        return real(x, w, eps)

    monkeypatch.setattr(rn, "rms_norm", counting)
    model = build_model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    tsteps.make_prefill_step(model)(model.init(0), {"tokens": tokens})
    assert len(seen) == (calls if kernel_path else 0)
    if kernel_path and family == "zamba2-published":
        # the shared blocks' first norm runs over concat([x, e])
        assert seen.count(2 * cfg.d_model) == len(cfg.hybrid.layer_ids)


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------

# rows of each width in the benchmark's cells (the registry's widths 64 and
# 12,288 at small counts): mamba2's 16 x 4096, zamba2's and olmoe's 2 x
# 4096, mixtral's 2 x 8192
CELL_ROWS = {64: 4096, 2048: 8192, 2560: 65536, 3584: 8192, 6144: 16384,
             7168: 8192, 12288: 2048}
ROWS = {"one": lambda d: 1, "odd": lambda d: 301, "cell": CELL_ROWS.get}


def _held_to_plain(x, w):
    spans.reset_counts()
    got = ops.rms_norm(x, w, EPS)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rms_norm"] == 1
    want = layers.rms_norm(x, w, EPS)
    assert got.dtype == want.dtype == x.dtype and got.shape == want.shape
    assert got.is_contiguous()
    differing = float((got != want).float().mean())
    print(f"rms_norm {tuple(x.shape)} {x.dtype}: share not bit-equal "
          f"{differing:.3e}")
    atol, rtol = fa.PLAIN_TOL[x.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("width", list(CELL_ROWS))
def test_kernel_matches_plain_on_card(width, dtype, rows):
    skip_without_cuda()
    x, w = _operands((ROWS[rows](width), width), dtype, device="cuda")
    _held_to_plain(x, w)


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 1, 2048), (2, 301, 3584),
                                   (2, 3, 5, 6144), (3, 96)],
                         ids=["decode", "3d", "4d", "2d"])
def test_kernel_matches_plain_at_the_call_sites_shapes_on_card(shape, dtype):
    skip_without_cuda()
    x, w = _operands(shape, dtype, device="cuda")
    _held_to_plain(x, w)


@requires_cuda
@pytest.mark.parametrize("case", ["column-slice", "w-float32"])
def test_kernel_takes_a_row_stride_and_a_float32_weight_on_card(case):
    skip_without_cuda()
    if case == "column-slice":
        base, _ = _operands((2, 33, 2560 + 64), torch.bfloat16, device="cuda")
        x = base[..., 32:32 + 2560]
        w = _operands((2560,), torch.bfloat16, device="cuda")[1]
    else:
        x, w = _operands((2, 33, 2560), torch.bfloat16, torch.float32, "cuda")
    _held_to_plain(x, w)


@requires_cuda
def test_the_bar_catches_a_per_head_norm_on_card():
    """The norm over each head of 128 where the QK-norm wants one over the
    whole 2048 channels misses the bar the kernel meets."""
    skip_without_cuda()
    x, w = _operands((8192, 2048), torch.bfloat16, device="cuda")
    got = ops.rms_norm(x, w, EPS)
    wrong = layers.rms_norm(x.unflatten(-1, (16, 128)), w.unflatten(-1, (16, 128)),
                            EPS).flatten(-2)
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    assert not np.allclose(got.float().cpu().numpy(),
                           wrong.float().cpu().numpy(), atol=atol, rtol=rtol)


@requires_cuda
def test_kernel_refuses_grad_on_card():
    skip_without_cuda()
    x, w = _operands((3, 64), torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rms_norm(x, w.requires_grad_(True), EPS)
    with torch.no_grad():
        assert ops.rms_norm(x, w, EPS).shape == (3, 64)
