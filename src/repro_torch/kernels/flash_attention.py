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
  * the CUDA kernels in ``csrc/flash_attention.cu`` (one block per 64 query
    rows of one head, the key loop inside the program; design notes in the
    source).  They take head dims ``SUPPORTED_HEAD_DIMS`` and any Sq, Sk:
    they mask ragged tails themselves, where the TPU wrapper fell back to
    the einsum oracle.  The dtype picks the kernel: bfloat16 runs
    FlashAttention-2 on the tensor cores (``mma.sync``, K/V by
    ``cp.async``), with P split into two bf16 parts for the P.V product
    (``_split_bf16`` is that arithmetic in PyTorch); float32 runs the
    CUDA-core kernel, since tensor-core TF32 would miss the float32 bar.
    Both are hand-written kernels and both count as launches.

``flash_attention_bhsd`` dispatches on where the tensors lie: CPU tensors
take the plain version, CUDA tensors launch the kernel (counted in
``LAUNCHES``).  Anything else raises — a CUDA call never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_bhsd", "flash_attention_reference", "NEG_INF",
           "LAUNCHES", "reset_launch_counts", "SUPPORTED_HEAD_DIMS",
           "PLAIN_TOL"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 256)   # csrc dispatch_d
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (atol, rtol) within which the kernel must give its plain version's
# output.  Both compute in float32 and round once to q's dtype, so they
# differ by float32 summation order and, in bfloat16, by at most one unit
# in the last place: 2**-7 of the value.  An absolute bar alone would not
# do: at Sq = 4096 late rows average over ~1500 keys and |out| is ~0.03.
PLAIN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 1e-2)}

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"flash_attention": 0}

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("flash_attention", "flash_attention.cu", _build.FMA_FLAGS)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _launch_cuda(q, k, v, group: int, causal: bool, window: Optional[int]):
    """Launch the CUDA kernel on the operands' card (no synchronisation)."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, group, window)
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash attention operands must share one device "
                             "and dtype")
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

    lib = _build.load_library(*LIBRARY)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:                  # first call: bind the signature
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
             sk, d, group, int(bool(causal)), 0 if window is None else window,
             _DTYPES[q.dtype], stream)
    _build.check_launch(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bhsd(q, k, v, *, group: int, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Flash attention in kernel layout (module doc).  CPU tensors run the
    plain version; CUDA tensors launch the hand-written kernel (counted in
    ``LAUNCHES``) and return without synchronising.  Mixed or other
    devices raise."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash_attention_bhsd takes torch tensors")
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_reference(q, k, v, group=group, causal=causal,
                                         window=window)
    if kinds == {"cuda"}:
        return _launch_cuda(q, k, v, group, causal, window)
    raise ValueError(f"flash attention operands on unsupported devices {kinds}")
