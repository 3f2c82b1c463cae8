"""Model-layout entry points of the two LM kernels, the counterparts of
``repro.kernels.ops``: the same transposes and reshapes around the
kernel-layout functions, which launch the CUDA kernel for CUDA tensors and
run its plain version for CPU tensors.  There is no shape fallback: the
flash kernel masks ragged lengths itself, and the SSD scan raises unless
the sequence is at most one chunk or a whole number of chunks (the
reference's ``ssd_reference`` asserts the same).  A ``DTensor`` operand
raises: a launch on its local shard would compute on a piece of the
tensor, and the model's plain path (``use_flash_kernel=False``) is the one
that runs under a mesh, as the reference never lowers a kernel there.

``force_reference=True`` calls the plain oracles of ``kernels.ref`` on any
device.  It is an explicit request, never a fallback: without it a CUDA
tensor launches the kernel or raises.  The reference's ``block_q``,
``block_k`` and ``interpret`` are not ported: they tile and interpret the
Pallas kernels, where the CUDA kernels pick their tiles at their C entry
points and the CPU runs the plain versions instead of an interpreter.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ssd_scan import ssd_scan_bhsp

__all__ = ["flash_attention", "ssd_scan"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    force_reference: bool = False) -> torch.Tensor:
    """Model layout: q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).  The
    softmax scale is applied to q in its own dtype, as the reference does,
    so bfloat16 rounds at the same place."""
    if force_reference:
        return kref.flash_attention_ref(q, k, v, causal=causal,
                                        sliding_window=sliding_window)
    _build.refuse_dtensor("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    qt = (q * d ** -0.5).transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kt = k.transpose(1, 2).reshape(b * kh, sk, d).contiguous()
    vt = v.transpose(1, 2).reshape(b * kh, sk, d).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, group=h // kh, causal=causal,
                               window=sliding_window)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 256,
             force_reference: bool = False):
    """Model layout: x (b,s,h,p), dt (b,s,h), a (h,), B/C (b,s,g,n).

    Returns (y (b,s,h,p) fp32, final_state (b,h,p,n) fp32).
    """
    s = x.shape[1]
    chunk = min(chunk, s)
    if force_reference:
        return kref.ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    _build.refuse_dtensor("ssd_scan", x, dt, a, bmat, cmat)
    if s % chunk:
        raise ValueError(f"the SSD scan needs the sequence ({s}) to be at most "
                         f"one chunk or a multiple of the chunk ({chunk})")
    xk = x.transpose(1, 2).contiguous()                      # (b,h,s,p)
    dtk = dt.transpose(1, 2)[:, :, None, :].contiguous()     # (b,h,1,s)
    bk = bmat.transpose(1, 2).contiguous()                   # (b,g,s,n)
    ck = cmat.transpose(1, 2).contiguous()
    y, state = ssd_scan_bhsp(xk, dtk, a.float(), bk, ck, chunk=chunk)
    return y.transpose(1, 2), state
