"""The Mamba2 SSD chunked scan, as a CUDA kernel.

Replaces ``repro.kernels.ssd_scan.ssd_scan_pallas`` (the Pallas TPU kernel
``_kernel``).  Kernel layout, as the reference's:

  x (B, H, S, P) float32 or bfloat16; dt (B, H, 1, S) float32;
  a (H,) float32 (negative); bmat, cmat (B, G, S, N) in x's dtype, heads
  grouped onto G banks (head ``h`` reads bank ``h // (H / G)``);
  -> y (B, H, S, P) float32 and the final state (B, H, P, N) float32.

Per chunk of ``chunk`` steps, with ``cum = cumsum(dt * a)`` and
``dax = dt * x``: ``y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dax_j +
exp(cum_i) C_i.S^T`` and ``S <- exp(cum_end) S + sum_j exp(cum_end - cum_j)
dax_j (x) B_j``; S starts at zero and its last value is returned.

Two implementations of one function live here:

  * ``ssd_scan_reference`` — the plain PyTorch version: a Python loop over
    the chunks on (B, H, ...) tensors, the TPU kernel body written out;
  * the CUDA kernels in ``csrc/ssd_scan.cu`` (design notes in the source),
    compiled for the ``(P, N)`` pairs in ``SUPPORTED_PN`` and chunks up to
    ``MAX_CHUNK``.  The dtype picks the design.  bfloat16 runs three
    kernels with the products on the tensor cores and the chunk axis
    parallel, over three scratches this wrapper allocates: chunk state
    and state passing (``mma.sync``), then the chunk scan, which is most
    of the call's time.  ``BF16_CHUNK_SCAN`` names the chunk-scan kernel of
    each (P, N, chunk): at (64, 64) (zamba2-7b) and (64, 128) (mamba2-370m)
    up to ``WGMMA_MAX_CHUNK`` steps ``ssd_wgmma_chunk_scan``, on Hopper's
    own instructions — one persistent block per SM over whole chunks, a
    producer warpgroup feeding C, B and x tiles and the entering state by
    TMA, two consumer warpgroups issuing ``wgmma``, each taking the query
    tiles that ``consumer_tiles`` deals it; elsewhere
    ``ssd_kernel_chunk_scan`` (``mma.sync``, one block per 64-row query
    tile).  The float32 operand of each product (the decay-weighted x, the
    entering state, the masked scores) is split into two bf16 parts
    (``_split_bf16`` is that arithmetic in PyTorch; the wgmma chunk scan
    takes the scores' hi part by truncation, ``_split_trunc``).  float32 runs the
    CUDA-core kernel, one block per (batch, head) looping over the chunks,
    since tensor-core TF32 would miss the float32 bars.  All are
    hand-written kernels; one call counts one launch.

``ssd_scan_bhsp`` dispatches on where the tensors lie: CPU tensors take the
plain version, CUDA tensors launch the kernels (counted in ``LAUNCHES``,
one per call).  Anything else raises — a CUDA call never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
# the bf16 kernels split the float32 side of each product (exp(cum_end -
# cum_j) dt_j x_j against B, the entering state against C, the masked
# scores against x) into bf16 hi + lo as flash attention splits P: one
# rounding to bf16 would miss the atol 2e-3 / rtol 1e-3 bar.  The tests
# hold that arithmetic in PyTorch; no path here calls it.
from repro_torch.kernels.flash_attention import _split_bf16  # noqa: F401

__all__ = ["ssd_scan_bhsp", "ssd_scan_reference", "LAUNCHES",
           "reset_launch_counts", "SUPPORTED_PN", "MAX_CHUNK",
           "WGMMA_MAX_CHUNK", "BF16_CHUNK_SCAN", "KERNEL_NAMES",
           "WGMMA_RING", "chunk_scan_kernel", "consumer_tiles"]

SUPPORTED_PN = ((16, 16), (32, 64), (64, 64), (64, 128), (128, 128))  # csrc SSD_SHAPES
MAX_CHUNK = 1024                                                      # csrc kMaxChunk
WGMMA_MAX_CHUNK = 256                                                 # csrc kWgMaxChunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The bf16 chunk-scan kernel of each (P, N): (longest chunk, kernel) bands,
# the first band that holds a call's chunk runs it.  The C entry point picks
# the same (chip_smoke.py holds it equal to the library's
# ssd_scan_bf16_chunk_scan).
BF16_CHUNK_SCAN = {
    pn: (((WGMMA_MAX_CHUNK, "ssd_wgmma_chunk_scan"),) if pn in ((64, 64), (64, 128))
         else ()) + ((MAX_CHUNK, "ssd_kernel_chunk_scan"),)
    for pn in SUPPORTED_PN}
# the wgmma kernel's ring at each of its (P, N): 64-step tiles (C, B and x
# rows) and buffers of the entering state, as csrc WgLayout sizes them to
# fit a block's shared memory
WGMMA_RING = {(64, 64): (7, 2), (64, 128): (4, 1)}
# every kernel of the library, as a profiler names them, and the part of a
# bf16 call each runs (the float32 kernel is a call of its own)
KERNEL_NAMES = {"ssd_kernel_chunk_state": "chunk_state",
                "ssd_kernel_state_pass": "state_pass",
                "ssd_wgmma_chunk_scan": "chunk_scan",
                "ssd_kernel_chunk_scan": "chunk_scan",
                "ssd_kernel": "float32"}

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"ssd_scan": 0}

# (name, source under csrc/, nvcc flags) for kernels._build
LIBRARY = ("ssd_scan", "ssd_scan.cu", _build.FMA_FLAGS)


def _split_trunc(x: torch.Tensor) -> tuple:
    """``x`` (float32) as ``hi + lo``, both bfloat16, as the wgmma chunk
    scan splits G (``csrc/ssd_scan.cu`` ``split_trunc``): ``hi`` is x
    truncated to bf16 (its upper 16 bits), ``lo = bf16(x - hi)``; hi + lo
    carries x to ~2^-16 of its size.  The tests use this to hold that
    arithmetic in PyTorch; no path here calls it."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chunk_scan_kernel(p: int, n: int, chunk: int) -> str:
    """The kernel that runs the chunk scan of a bf16 call (``BF16_CHUNK_SCAN``)."""
    return next(name for longest, name in BF16_CHUNK_SCAN[(p, n)] if chunk <= longest)


def consumer_tiles(n_tiles: int) -> tuple:
    """The 64-row query tiles of a chunk that each of the wgmma kernel's two
    consumer warpgroups computes, as two tuples in ascending order: from
    the heaviest tile down (tile t pairs with key tiles 0..t), each tile goes
    to the consumer with fewer (query tile, key tile) pairs so far, the
    first on a tie.  At 4 tiles: (0, 3) and (1, 2), 5 pairs each.  The C
    kernel's ``consumer_tiles`` is the same rule."""
    load, mine = [0, 0], ([], [])
    for t in range(n_tiles - 1, -1, -1):
        who = 1 if load[1] < load[0] else 0
        load[who] += t + 1
        mine[who].append(t)
    return tuple(sorted(mine[0])), tuple(sorted(mine[1]))


def _check(x, dt, a, bmat, cmat, chunk: int) -> None:
    if x.dim() != 4 or bmat.dim() != 4 or cmat.shape != bmat.shape:
        raise ValueError(f"ssd_scan takes x (B,H,S,P) and B/C (B,G,S,N); got "
                         f"{tuple(x.shape)}, {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)}")
    b, h, s, _ = x.shape
    g = bmat.shape[1]
    if bmat.shape[0] != b or bmat.shape[2] != s or g < 1 or h % g:
        raise ValueError(f"B/C {tuple(bmat.shape)} do not match x {tuple(x.shape)}")
    if tuple(dt.shape) != (b, h, 1, s) or tuple(a.shape) != (h,):
        raise ValueError(f"dt must be (B,H,1,S) and a (H,); got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")


def ssd_scan_reference(x, dt, a, bmat, cmat, *, chunk: int):
    """Plain PyTorch version of the kernel (same layout, float32 math)."""
    _check(x, dt, a, bmat, cmat, chunk)
    b, h, s, p = x.shape
    g, n = bmat.shape[1], bmat.shape[3]
    bank = torch.arange(h, device=x.device) // (h // g)
    xf, dtf, af = x.float(), dt[:, :, 0].float(), a.float()
    bf, cf = bmat.float()[:, bank], cmat.float()[:, bank]          # (b,h,s,n)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    y = torch.empty(b, h, s, p, dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dtf[..., sl]                                          # (b,h,q)
        cum = torch.cumsum(dtc * af[:, None], dim=-1)
        dax = xf[:, :, sl] * dtc[..., None]                         # (b,h,q,p)
        bq, cq = bf[:, :, sl], cf[:, :, sl]                         # (b,h,q,n)
        decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                            torch.zeros((), device=x.device))
        yc = ((cq @ bq.transpose(-1, -2)) * decay) @ dax
        yc = yc + torch.exp(cum)[..., None] * (cq @ state.transpose(-1, -2))
        w = torch.exp(cum[..., -1:] - cum)[..., None]               # (b,h,q,1)
        state = state * torch.exp(cum[..., -1])[..., None, None] \
            + (dax * w).transpose(-1, -2) @ bq
        y[:, :, sl] = yc
    return y, state


def _launch_cuda(x, dt, a, bmat, cmat, chunk: int,
                 lib: Optional[ctypes.CDLL] = None):
    """Launch the CUDA kernel on the operands' card (no synchronisation).
    ``lib`` is this package's library unless a caller passes another build
    of the same C interface (another checkout's, to compare the two)."""
    _build.refuse_dtensor("ssd_scan", x, dt, a, bmat, cmat)
    _build.refuse_grad("ssd_scan", x, dt, a, bmat, cmat)
    _check(x, dt, a, bmat, cmat, chunk)
    ops = (x, dt, a, bmat, cmat)
    if any(t.device != x.device for t in ops):
        raise ValueError("ssd_scan operands must lie on one device")
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"the SSD kernel takes x, B, C in float32 or bfloat16 "
                        f"alike; got {x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("the SSD kernel takes dt and a in float32")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the SSD kernel takes contiguous operands")
    b, h, s, p = x.shape
    g, n = bmat.shape[1], bmat.shape[3]
    if (p, n) not in SUPPORTED_PN:
        raise ValueError(f"the SSD kernel is compiled for (P, N) in "
                         f"{SUPPORTED_PN}; got {(p, n)}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the SSD kernel takes chunks up to {MAX_CHUNK}; got {chunk}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and b * h > 65535:
        raise ValueError(f"the bf16 SSD kernels take B * H up to 65535 (their "
                         f"grid's y); got {b * h}")
    if bf16 and any(t.data_ptr() % 16 for t in (x, bmat, cmat)):
        raise ValueError("the bf16 SSD kernels copy 16-byte rows: x, B and C "
                         "must start 16-byte aligned")

    if lib is None:
        lib = _build.load_library(*LIBRARY)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:                  # first call: bind the signature
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # bf16 scratches: cum per step; per chunk its local state (float32) and
    # the state entering it, split into bf16 hi and lo.  They are held until
    # the kernels are queued; memory reused later on this stream is ordered
    # after them.
    scratch = []
    if bf16:
        nc = s // chunk
        scratch = [torch.empty(shape, dtype=dtype, device=x.device)
                   for shape, dtype in (((b, h, s), torch.float32),
                                        ((b, h, nc, p, n), torch.float32),
                                        ((b, h, nc, 2, p, n), torch.bfloat16))]
    ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
             cmat.data_ptr(), y.data_ptr(), state.data_ptr(), *ptrs,
             b, h, g, s, p, n, chunk, _DTYPES[x.dtype], stream)
    _build.check_launch(lib, "ssd_scan", err)
    LAUNCHES["ssd_scan"] += 1
    return y, state


def ssd_scan_bhsp(x, dt, a, bmat, cmat, *, chunk: int = 256):
    """SSD scan in kernel layout (module doc); returns ``(y, final_state)``.
    CPU tensors run the plain version; CUDA tensors launch the
    hand-written kernel (counted in ``LAUNCHES``) and return without
    synchronising.  Mixed or other devices raise."""
    ops = (x, dt, a, bmat, cmat)
    if not all(isinstance(t, torch.Tensor) for t in ops):
        raise TypeError("ssd_scan_bhsp takes torch tensors")
    kinds = {t.device.type for t in ops}
    if kinds == {"cpu"}:
        return ssd_scan_reference(x, dt, a, bmat, cmat, chunk=chunk)
    if kinds == {"cuda"}:
        return _launch_cuda(x, dt, a, bmat, cmat, chunk)
    raise ValueError(f"ssd_scan operands on unsupported devices {kinds}")
