"""The Mamba2 mixer's causal depthwise conv, from the in projection's xBC
columns to the SiLU'd rows the SSD scan and the gated norm read, as one
CUDA kernel.

Replaces no Pallas kernel: the JAX package leaves this chain to XLA
(``repro.models.ssm._causal_conv``), which fuses it, where PyTorch runs it
eagerly as about 13 launches a layer, each a full pass over the (tokens x
C) activations.  Layout, as ``models/ssm.py`` holds the operands:

  x (B, S, C) in the model's dtype T (float32 or bfloat16), rows with their
  channels contiguous and any row stride (the xBC column slice of the in
  projection's output); w (W, C) T; b (C,) T;  -> (B, S, C) T, contiguous.

Per sequence, token t and channel c, with x[t'] = 0 for t' < 0, at the
PyTorch chain's rounding points:

  o = T(0 + T(x[t-W+1] w[0]));  o = T(o + T(x[t-W+1+i] w[i])), i = 1 .. W-1
  out = T(silu(T(o + b)))

Two implementations of one function live here:

  * ``causal_conv_reference`` — the plain PyTorch chain, the mixer's plain
    path (``models.ssm._causal_conv``, through ``shard_local`` for
    DTensors);
  * the CUDA kernel ``causal_conv_kernel`` in ``csrc/causal_conv.cu``
    (design notes in the source): one thread a 16-byte vector of channels
    over a segment of tokens, its rows through a ring of ``cp.async``
    stages in shared memory, the weights and the last W-1 rows in
    registers; x is read once and the output written once, which is its
    bound.  bf16 sums are one bf16x2 add each, the same value as the
    chain's float32 sum rounded to bf16 (the source says why).

``causal_conv`` dispatches on where the tensors lie: CPU tensors take the
plain version, CUDA tensors launch the kernel (counted in ``LAUNCHES``, one
per call).  Anything else raises (``_build.dispatch``).  Both check the
operands first: a rank other than 3, a width outside 2-4, a channel count
no multiple of 8, or a pointer or row stride no multiple of 16 bytes raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import _build

__all__ = ["causal_conv", "causal_conv_reference", "segment", "LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (2, 3, 4)           # csrc: the taps the kernel is built for
_THREADS = 32                # csrc kThreads: channel vectors a block

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = spans.counter("causal_conv")

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("causal_conv", "causal_conv.cu", _build.FMA_FLAGS)
# the C entry point's argument types, the stream's last
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5 \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def causal_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: x (B, S, C) padded with W-1 zero rows in
    front, W shifted products summed into zeros, the bias, the SiLU."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _aligned(t: torch.Tensor) -> bool:
    """t starts 16-byte aligned and, past its contiguous last dim, steps
    16-byte multiples along every dim it has more than one row on."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0
        for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def _check(x, w, b) -> None:
    """Raise unless the operands are the mixer's: x (B, S, C), w (W, C) with
    W in ``WIDTHS``, b (C,), C a multiple of 8 (a thread of the kernel
    takes 16 bytes of channels), all in float32 or bfloat16 alike, channels
    contiguous, every pointer and row stride a multiple of 16 bytes."""
    if x.dim() != 3:
        raise ValueError(f"the causal conv takes x (B, S, C): rank 3, got rank "
                         f"{x.dim()}")
    c = x.shape[2]
    if w.dim() != 2 or w.shape[1] != c or tuple(b.shape) != (c,):
        raise ValueError(f"the causal conv takes w (W, C) and b (C,) for C = "
                         f"{c}; got {tuple(w.shape)}, {tuple(b.shape)}")
    if w.shape[0] not in WIDTHS:
        raise ValueError(f"the causal conv kernel is built for widths "
                         f"{WIDTHS}; got width {w.shape[0]}")
    if c % 8:
        raise ValueError(f"the causal conv kernel takes a channel count that is "
                         f"a multiple of 8; got {c}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"the causal conv takes x, w and b in float32 or "
                        f"bfloat16 alike; got {x.dtype}, {w.dtype}, {b.dtype}")
    if x.stride(2) != 1 or not w.is_contiguous() or not b.is_contiguous():
        raise ValueError("the causal conv takes rows with contiguous channels: "
                         "x's last dim, w and b")
    if not (_aligned(x) and _aligned(w) and _aligned(b)):
        raise ValueError("the causal conv kernel moves 16 bytes at a time: x, w "
                         "and b must start 16-byte aligned and x's strides be "
                         "multiples of 16 bytes")


def segment(batch: int, seq: int, channels: int, elem: int,
            sms: int = 132) -> int:
    """Tokens a thread walks: 64, halved down to 16 while the launch has
    fewer threads than 8 waves of the 512 a multiprocessor holds (16 warps
    at the kernel's registers; the wrapper passes the card's count), so
    that small batches still fill the card.  64 is the best of 32-256 at
    mamba2-2.7b's prefill; 16-60 read alike at zamba2-7b's."""
    vecs = -(-channels * elem // 16)
    threads = -(-vecs // _THREADS) * _THREADS
    seg = 64
    while seg > 16 and batch * -(-seq // seg) * threads < 8 * 512 * sms:
        seg //= 2
    return seg


def _launch_cuda(x, w, b, lib: Optional[ctypes.CDLL] = None,
                 seg: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the operands' card (no synchronisation).
    ``lib`` is this package's library unless a caller passes another build
    of the same C interface (another checkout's, to compare the two);
    ``seg`` forces the tokens a thread walks (tests, timing)."""
    _build.refuse("causal_conv", x, w, b)
    _check(x, w, b)
    bsz, s, c = x.shape
    if seg is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        seg = segment(bsz, s, c, x.element_size(), sms)
    if bsz > 65535 or -(-s // seg) > 65535:
        raise ValueError(f"the causal conv kernel takes up to 65535 sequences "
                         f"and 65535 segments of {seg} tokens; got {bsz} x {s}")
    out = torch.empty((bsz, s, c), dtype=x.dtype, device=x.device)
    if lib is None:
        lib = _build.load_library(*LIBRARY)
    _build.launch(lib, "causal_conv",
                  "causal_conv_launch", _ARGTYPES, x.device, x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, c,
                  x.stride(0), x.stride(1), w.shape[0], seg, _DTYPES[x.dtype])
    return out


def causal_conv(x, w, b) -> torch.Tensor:
    """The causal conv and its SiLU (module doc).  Checks the operands on
    every device; CPU tensors then run the plain version, CUDA tensors
    launch the hand-written kernel (counted in ``LAUNCHES``) and return
    without synchronising.  Mixed or other devices raise."""
    def plain():
        _check(x, w, b)
        return causal_conv_reference(x, w, b)

    return _build.dispatch("causal_conv", (x, w, b), plain,
                           lambda: _launch_cuda(x, w, b))
