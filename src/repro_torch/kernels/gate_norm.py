"""The Mamba2 mixer's gated norm, from the SSD scan's float32 y to the normed
rows the out projection reads, as one CUDA kernel.

Replaces no Pallas kernel: the JAX package leaves this chain to XLA
(``repro.models.ssm.ssm_mixer``), which fuses it, where PyTorch runs it
eagerly as about 16 launches a layer, each a full pass over the (tokens x
d_inner) activations.  Layout, as ``models/ssm.py`` holds the operands:

  y (B, S, H, P) float32, any strides with P contiguous (the transposed
  view of the SSD kernel's (B, H, S, P) buffer); x (B, S, H, P) and z
  (B, S, H P) in the model's dtype T (float32 or bfloat16), rows with their
  channels contiguous (column slices of the conv's and the in projection's
  outputs); d (H,) float32; w (H P,) T;  -> (B, S, H P) T.

Per token and channel c of head h = c // P, at the PyTorch chain's rounding
points (``models/ssm.py`` and ``layers.rms_norm``), over each of ``groups``
equal groups of channels:

  t = T(y + d[h] * x);  g = T(silu(z));  v = T(t * g)
  out = T(v * rsqrt(mean(v^2 over the group) + eps) * (1 + w))

Two implementations of one function live here:

  * ``gate_norm_reference`` — the plain PyTorch version, the mixer's plain
    path (``models.ssm.gated_norm_skip_reference``);
  * the CUDA kernel ``ssm_gate_norm_kernel`` in ``csrc/gate_norm.cu``
    (design notes in the source): one warp per token, 16-byte accesses
    (so every pointer and row stride is 16-byte aligned, as fresh tensors
    and their column slices at the mixer's widths are), the gated product
    kept in shared memory between the group's sum of squares and the
    scale; the operands are read once and the output written once, which
    is its bound.

``gate_norm`` dispatches on where the tensors lie: CPU tensors take the
plain version, CUDA tensors launch the kernel (counted in ``LAUNCHES``, one
per call).  Anything else raises (``_build.dispatch``).  Both check the
shapes: a group width no multiple of 8, or a head dim no multiple of 4, raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spans
from repro_torch.kernels import _build

__all__ = ["gate_norm", "gate_norm_reference", "LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 4                   # csrc kWarps: tokens a block, one a warp
_MAX_SMEM = 232448           # csrc kMaxSmem: a block's shared memory

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = spans.counter("gate_norm")

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("gate_norm", "gate_norm.cu", _build.FMA_FLAGS)
# the C entry point's argument types, the stream's last
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 9 \
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(y, x, d, z, w, groups: int) -> None:
    """Raise unless the operands are the mixer's: y and x (B, S, H, P), z
    (B, S, H P), d (H,), w (H P,), H P split into ``groups`` groups whose
    width is a multiple of 8, P a multiple of 4 (a lane of the kernel takes
    8 channels of one group, each 4 of one head)."""
    if y.dim() != 4 or tuple(x.shape) != tuple(y.shape):
        raise ValueError(f"the gated norm takes y and x (B, S, H, P); got "
                         f"{tuple(y.shape)}, {tuple(x.shape)}")
    b, s, h, p = y.shape
    if tuple(z.shape) != (b, s, h * p) or tuple(d.shape) != (h,) \
            or tuple(w.shape) != (h * p,):
        raise ValueError(f"z must be (B, S, H P), d (H,) and w (H P,) for y "
                         f"{tuple(y.shape)}; got {tuple(z.shape)}, "
                         f"{tuple(d.shape)}, {tuple(w.shape)}")
    if groups < 1 or (h * p) % groups:
        raise ValueError(f"{h * p} channels do not split into {groups} groups")
    width = h * p // groups
    if width % 8 or p % 4:
        raise ValueError(f"the gated norm kernel takes a group width that is a "
                         f"multiple of 8 and a head dim that is a multiple of "
                         f"4; got width {width}, head dim {p}")


def gate_norm_reference(y, x, d, z, w, groups: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version: the mixer's own plain path
    (``models.ssm.gated_norm_skip_reference``), on the kernel's shapes."""
    from repro_torch.models.ssm import gated_norm_skip_reference

    _check(y, x, d, z, w, groups)
    return gated_norm_skip_reference(y, x, d, z, w, groups, eps)


def _aligned(t: torch.Tensor, strides) -> bool:
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(st * size % 16 == 0 for st in strides)


def _launch_cuda(y, x, d, z, w, groups: int, eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on the operands' card (no synchronisation)."""
    _build.refuse("gate_norm", y, x, d, z, w)
    _check(y, x, d, z, w, groups)
    if y.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"the gated norm kernel takes y and d in float32; got "
                        f"{y.dtype}, {d.dtype}")
    if x.dtype not in _DTYPES or z.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError(f"the gated norm kernel takes x, z and w in float32 or "
                        f"bfloat16 alike; got {x.dtype}, {z.dtype}, {w.dtype}")
    b, s, h, p = y.shape
    width = h * p // groups
    if _WARPS * width * x.element_size() > _MAX_SMEM:
        raise ValueError(f"the gated norm kernel keeps {_WARPS} rows of a group "
                         f"in a block's shared memory: a group of {width} "
                         f"{x.dtype} channels is too wide")
    if y.stride(3) != 1 or x.stride(3) != 1 or x.stride(2) != p \
            or z.stride(2) != 1 or not w.is_contiguous() or not d.is_contiguous():
        raise ValueError("the gated norm kernel takes rows with contiguous "
                         "channels: y's P, x's (H, P), z's last dim, d and w")
    if not (_aligned(y, y.stride()[:3]) and _aligned(x, x.stride()[:2])
            and _aligned(z, z.stride()[:2]) and _aligned(w, ())):
        raise ValueError("the gated norm kernel moves 16 bytes at a time: y, x, "
                         "z and w must start 16-byte aligned and their row "
                         "strides be multiples of 16 bytes")
    out = torch.empty((b, s, h * p), dtype=x.dtype, device=y.device)
    _build.launch(_build.load_library(*LIBRARY), "gate_norm", "gate_norm_launch",
                  _ARGTYPES, y.device, y.data_ptr(), x.data_ptr(), d.data_ptr(),
                  z.data_ptr(), w.data_ptr(), out.data_ptr(), b * s, s,
                  *y.stride()[:3], *x.stride()[:2], *z.stride()[:2], h, p,
                  groups, eps, _DTYPES[x.dtype])
    return out


def gate_norm(y, x, d, z, w, *, groups: int, eps: float) -> torch.Tensor:
    """The gated norm from the scan's y (module doc).  CPU tensors run the
    plain version; CUDA tensors launch the hand-written kernel (counted in
    ``LAUNCHES``) and return without synchronising.  Mixed or other devices
    raise."""
    return _build.dispatch(
        "gate_norm", (y, x, d, z, w),
        lambda: gate_norm_reference(y, x, d, z, w, groups, eps),
        lambda: _launch_cuda(y, x, d, z, w, groups, eps))
