"""RMSNorm with the port's ``1 + w`` scale, as one CUDA kernel: every block
norm, final norm and QK-norm of the LM path on the card.

Replaces no Pallas kernel: the JAX package leaves this chain to XLA
(``repro.models.layers.rms_norm``), which fuses it, where PyTorch runs it
eagerly as about ten launches a call (cast, square, mean, ``+ eps``, rsqrt,
multiply, the weight's cast, ``1 + w``, multiply, cast back), each a full
pass over the (rows x D) activations: ~40 bytes moved an element in bf16.
Layout, as the models hold the operands:

  x (..., D) in the model's dtype T (float32 or bfloat16), rows with their
  channels contiguous (any row stride: a residual stream, a projection's
  output, a concat); w (D,) float32 or bfloat16;  -> (..., D) T, contiguous.

Per row, at ``layers.rms_norm``'s rounding points:

  r = rsqrt(mean(float(x)^2) + eps);  out = T((float(x) * r) * (1 + float(w)))

Two implementations of one function live here:

  * the plain version is ``models.layers.rms_norm`` itself, bit for bit;
  * the CUDA kernel ``rms_norm_kernel`` in ``csrc/rms_norm.cu`` (design
    notes in the source).  Its bound is bytes: each row read once and
    written once, 4 bytes an element in bf16 (w, shared by every row, from
    the read-only cache).  A row's threads are a power of two picked from D
    so that each holds 2-4 vectors of 8 channels in registers between the
    sum of squares and the scale (16-byte accesses, so every pointer and
    row stride is 16-byte aligned); the row's sum by shuffles, and past a
    warp through shared memory.

``rms_norm`` checks the operands on every device, then dispatches on where
they lie: CPU tensors take the plain version, CUDA tensors launch the kernel
(counted in ``LAUNCHES``, one per call).  Anything else raises
(``_build.dispatch``).  A width no multiple of 8 or above ``MAX_WIDTH``, rows
that are not contiguous, or a pointer or row stride no multiple of 16 bytes
raises on every device: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spans
from repro_torch.kernels import _build

__all__ = ["rms_norm", "LAUNCHES", "MAX_WIDTH"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 16384            # csrc kMaxWidth: 512 threads x 4 vectors of 8

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = spans.counter("rms_norm")

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("rms_norm", "rms_norm.cu", _build.FMA_FLAGS)
# the C entry point's argument types, the stream's last
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x as (rows, D) with its own row stride, after the checks every device
    makes: w (D,), D a multiple of 8 up to ``MAX_WIDTH`` (a thread of the
    kernel takes 8 channels), both float32 or bfloat16, the channels of
    every row contiguous, every pointer and the row stride a multiple of 16
    bytes."""
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(w.shape) != (d,):
        raise ValueError(f"the RMSNorm takes x (..., D) and w (D,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if d % 8 or not 8 <= d <= MAX_WIDTH:
        raise ValueError(f"the RMSNorm kernel takes a width that is a multiple "
                         f"of 8 up to {MAX_WIDTH}; got {d}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"the RMSNorm kernel takes x and w in float32 or "
                        f"bfloat16; got {x.dtype}, {w.dtype}")
    try:
        rows = x.view(-1, d)
    except RuntimeError:
        rows = None
    if rows is None or rows.stride(1) != 1 or w.stride(0) != 1:
        raise ValueError("the RMSNorm kernel takes rows with contiguous "
                         "channels at one row stride, and a contiguous w")
    if (x.data_ptr() % 16 or w.data_ptr() % 16
            or rows.stride(0) * x.element_size() % 16):
        raise ValueError("the RMSNorm kernel moves 16 bytes at a time: x and w "
                         "must start 16-byte aligned and x's row stride be a "
                         "multiple of 16 bytes")
    return rows


def _launch_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on the operands' card (no synchronisation)."""
    _build.refuse("rms_norm", x, w)
    rows = _rows(x, w)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return out
    _build.launch(_build.load_library(*LIBRARY), "rms_norm", "rms_norm_launch",
                  _ARGTYPES, x.device, rows.data_ptr(), w.data_ptr(),
                  out.data_ptr(), rows.shape[0], rows.stride(0), rows.shape[1],
                  eps, _DTYPES[x.dtype], _DTYPES[w.dtype])
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``layers.rms_norm(x, w, eps)`` (module doc).  Checks the operands on
    every device; CPU tensors then run ``layers.rms_norm`` itself, CUDA
    tensors launch the hand-written kernel (counted in ``LAUNCHES``) and
    return without synchronising.  Mixed or other devices raise."""
    from repro_torch.models import layers

    def plain():
        _rows(x, w)
        return layers.rms_norm(x, w, eps)

    return _build.dispatch("rms_norm", (x, w), plain,
                           lambda: _launch_cuda(x, w, eps))
