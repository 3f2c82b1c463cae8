"""Causal GQA flash attention (optional sliding window), as a CUDA kernel.

Replaces ``repro.kernels.flash_attention.flash_attention_bhsd`` (the Pallas
TPU kernel ``_kernel``).  Kernel layout, as the reference's:

  q (BH, Sq, d) — batch x query heads, already scaled by ``d ** -0.5``;
  k, v (BK, Sk, d) — batch x KV heads, ``BK = BH / group``;
  -> (BH, Sq, d) in q's dtype.  Query head ``bh`` reads KV head
  ``bh // group``; with ``causal`` the queries are the suffix of the keys
  (``q_offset = Sk - Sq``) and ``window`` keeps keys ``j > i - window``.

Two implementations of one function live here:

  * ``flash_attention_reference`` — the plain PyTorch version: float32
    scores, masked to ``NEG_INF``, one softmax over all keys (the online
    softmax's result in one step), float32 product with v;
  * the CUDA kernels in ``csrc/flash_attention.cu`` (the key loop inside
    the program; design notes in the source).  They take head dims
    ``SUPPORTED_HEAD_DIMS`` and any Sq, Sk: they mask ragged tails
    themselves, where the TPU wrapper fell back to the einsum oracle.  The
    dtype and head dim pick the kernel (``BF16_KERNEL``): bfloat16 at head
    dims 64, 112 and 128 runs ``flash_wgmma_kernel`` on Hopper's own
    instructions — one persistent block per SM over 128-row query tiles, a
    producer warpgroup feeding Q and a 4-stage ring of 64-key K/V tiles by
    TMA, two consumer warpgroups of 64 rows issuing ``wgmma`` (the softmax
    of the next key block beside the current P.V product); bfloat16 at 16,
    32, 224 (the published Zamba2's shared attention) and 256 runs
    ``flash_mma_kernel`` (``mma.sync``, K/V by ``cp.async``).  Both bf16 kernels split P into two bf16 parts for the
    P.V product (``_split_bf16`` is that arithmetic in PyTorch), issuing
    6 d flop per kept (query, key) pair where the function needs 4 d;
    they are bound by the tensor cores and, for the wgmma kernel, by the
    K/V traffic each 128-row tile reads from L2.  float32 runs the
    CUDA-core kernel, since tensor-core TF32 would miss the float32 bar.
    All are hand-written kernels and all count as launches.

``flash_attention_bhsd`` dispatches on where the tensors lie: CPU tensors
take the plain version, CUDA tensors launch the kernel (counted in
``LAUNCHES``).  Anything else raises (``_build.dispatch``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels import _build

__all__ = ["flash_attention_bhsd", "flash_attention_reference", "NEG_INF",
           "LAUNCHES", "SUPPORTED_HEAD_DIMS",
           "PLAIN_TOL", "BF16_TILES", "BF16_KERNEL", "KERNEL_NAMES"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 224, 256)   # csrc dispatch_d
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel per head dim, and its tiles (query rows per block, keys
# per step of the loop, ring stages), as csrc/flash_attention.cu's
# WgLayout / MmaLayout give them (chip_smoke.py holds them equal to the C
# query flash_attention_bf16_tiles): the wgmma kernel at the LM paths' head
# dims, the mma.sync kernel at the rest
BF16_KERNEL = {16: "flash_mma_kernel", 32: "flash_mma_kernel",
               64: "flash_wgmma_kernel", 112: "flash_wgmma_kernel",
               128: "flash_wgmma_kernel", 224: "flash_mma_kernel",
               256: "flash_mma_kernel"}
BF16_TILES = {16: (64, 64, 2), 32: (64, 64, 2), 64: (128, 64, 4),
              112: (128, 64, 4), 128: (128, 64, 4), 224: (64, 32, 2),
              256: (64, 32, 2)}
# every kernel of the library, as a profiler names them
KERNEL_NAMES = ("flash_wgmma_kernel", "flash_mma_kernel", "flash_kernel")
# (atol, rtol) within which the kernel must give its plain version's
# output.  Both compute in float32 and round once to q's dtype, so they
# differ by float32 summation order and, in bfloat16, by at most one unit
# in the last place: 2**-7 of the value.  An absolute bar alone would not
# do: at Sq = 4096 late rows average over ~1500 keys and |out| is ~0.03.
PLAIN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 1e-2)}

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = spans.counter("flash_attention")

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("flash_attention", "flash_attention.cu", _build.FMA_FLAGS)
# the C entry point's argument types, the stream's last
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _check(q, k, v, group: int, window: Optional[int]) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (BH,Sq,d) and k, v "
                         f"(BK,Sk,d); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if group < 1 or q.shape[0] != k.shape[0] * group or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} with group {group}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1; got {window}")


def flash_attention_reference(q, k, v, *, group: int, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same layout and numerics)."""
    _check(q, k, v, group, window)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    kv_head = torch.arange(bh, device=q.device) // group
    kf, vf = k.float()[kv_head], v.float()[kv_head]
    s = q.float() @ kf.transpose(1, 2)                       # (BH, Sq, Sk)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def _split_bf16(x: torch.Tensor) -> tuple:
    """``x`` (float32) as ``hi + lo``, both bfloat16: ``hi = bf16(x)``,
    ``lo = bf16(x - hi)`` (``csrc/mma_sm90.cuh`` ``split_bf16``).  The bf16
    kernel splits the probabilities P so before its P.V product and issues
    one product per part against the same bf16 V; one rounding to bf16
    would miss ``PLAIN_TOL``.  The SSD kernels split their float32
    operands the same way (``ssd_scan``).  The tests use this to hold that
    arithmetic in PyTorch; no path here calls it."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _launch_cuda(q, k, v, group: int, causal: bool, window: Optional[int],
                 lib: Optional[ctypes.CDLL] = None):
    """Launch the CUDA kernel on the operands' card (no synchronisation).
    ``lib`` is this package's library unless a caller passes another build
    of the same C interface (another checkout's, to compare the two)."""
    _build.refuse("flash_attention", q, k, v)
    _check(q, k, v, group, window)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash attention operands must share one dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16; got {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("the flash kernel takes contiguous operands")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash kernel is compiled for head dims "
                         f"{SUPPORTED_HEAD_DIMS}; got {d}")
    if bh < 1 or sq < 1 or sk < 1 or -(-sq // 64) > 65535:
        raise ValueError(f"unsupported flash attention shape {tuple(q.shape)}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel copies 16-byte rows: q, k and "
                         "v must start 16-byte aligned")

    if lib is None:
        lib = _build.load_library(*LIBRARY)
    out = torch.empty_like(q)
    _build.launch(lib, "flash_attention", "flash_attention_launch", _ARGTYPES,
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), bh, sq, sk, d, group, int(bool(causal)),
                  0 if window is None else window, _DTYPES[q.dtype])
    return out


def flash_attention_bhsd(q, k, v, *, group: int, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Flash attention in kernel layout (module doc).  CPU tensors run the
    plain version; CUDA tensors launch the hand-written kernel (counted in
    ``LAUNCHES``) and return without synchronising.  Mixed or other
    devices raise."""
    return _build.dispatch(
        "flash_attention_bhsd", (q, k, v),
        lambda: flash_attention_reference(q, k, v, group=group, causal=causal,
                                          window=window),
        lambda: _launch_cuda(q, k, v, group, causal, window))
