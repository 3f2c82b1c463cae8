"""Mamba2 mixer: state-space duality (SSD) with a chunked scan, the
counterpart of ``repro.models.ssm``.

Per-head scalar decay ``a_t = exp(-exp(A_log) * dt_t)``, grouped B/C, a
short causal depthwise conv over the (x, B, C) stream, gated RMSNorm and
the out projection.  ``ssd_reference`` is the chunked oracle in model
layout; ``ssm_mixer(use_kernel=True)`` goes through ``kernels.ops.ssd_scan``
(the CUDA kernel on the card, its plain version on the CPU).
``ssm_decode_step`` is the one-token recurrent form.  ``jax.nn.softplus``
is ``logaddexp(x, 0)``, which ``F.softplus`` (threshold 20) is not.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.api import ModelConfig, SSMConfig
from repro_torch.parallel.dtensor_ops import (shard_local, shards_dim,
                                              split_columns)

__all__ = ["ssm_spec", "ssm_mixer", "ssd_reference", "SSMState",
           "init_ssm_state", "ssm_decode_step"]


def _dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, n_heads, conv_dim


def ssm_spec(d_model: int, s: SSMConfig, dtype) -> dict:
    """Parameter spec (shape, dtype, init) of one mixer, as ``init_ssm``."""
    d_inner, n_heads, conv_dim = _dims(d_model, s)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.state_dim + n_heads  # z,x,B,C,dt
    f32 = torch.float32
    return {
        "in_proj": ((d_model, proj_out), dtype, d_model ** -0.5),
        "conv_w": ((s.conv_width, conv_dim), dtype, 0.1),
        "conv_b": ((conv_dim,), dtype, "zeros"),
        "A_log": ((n_heads,), f32, "zeros"),          # A = -exp(A_log) = -1
        "D": ((n_heads,), f32, "ones"),
        "dt_bias": ((n_heads,), f32, "zeros"),
        "norm_w": ((d_inner,), dtype, "zeros"),
        "out_proj": ((d_inner, d_model), dtype, d_inner ** -0.5),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (W, C); for DTensors on each
    rank's own rows and channels (``parallel.dtensor_ops.shard_local``)."""
    return shard_local(_causal_conv_local, (x, w, b),
                       ((0, 2), (None, 1), (None, 0)), ((0, 2),))


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _split_proj(p: dict, u: torch.Tensor, d_model: int, s: SSMConfig):
    """The in-projection's (z, xBC, dt).  A DTensor ``in_proj`` sharded on
    its columns, meeting more tokens than it has rows, projects piece by
    piece (``parallel.dtensor_ops.split_columns``): the split of its fused
    output would gather the larger activations; with fewer tokens (decode)
    gathering the output is the cheaper."""
    d_inner, n_heads, conv_dim = _dims(d_model, s)
    sizes = [d_inner, conv_dim, n_heads]
    if shards_dim(p["in_proj"], 1) and u.numel() > u.shape[-1] ** 2:
        z, xbc, dt = (layers.dense(u, w)
                      for w in split_columns(p["in_proj"], sizes))
    else:
        zxbcdt = layers.dense(u, p["in_proj"])
        z, xbc, dt = torch.split(zxbcdt, sizes, dim=-1)
    return z, xbc, dt, d_inner, n_heads


def ssd_reference(x, dt, A, B, C, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan (oracle).

    x: (b, s, h, p)   dt: (b, s, h)   A: (h,) negative reals
    B, C: (b, s, g, n)  heads h are grouped onto g = n_groups B/C banks.
    Returns (y (b,s,h,p), final_state (b,h,p,n)), float32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    rep = h // g
    dax = (dt[..., None] * x).float()                        # (b,s,h,p)
    la = (dt * A).float()                                    # (b,s,h)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xq, laq = dax[:, sl], la[:, sl]
        Bh = B[:, sl].float().repeat_interleave(rep, dim=2)  # (b,q,h,n)
        Ch = C[:, sl].float().repeat_interleave(rep, dim=2)
        cum = torch.cumsum(laq, dim=1)                       # (b,q,h)
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (b,i,j,h)
        L = torch.where(tri[None, :, :, None], torch.exp(diff),
                        torch.zeros((), device=x.device))
        scores = torch.einsum("bihn,bjhn->bijh", Ch, Bh) * L
        y = torch.einsum("bijh,bjhp->bihp", scores, xq)
        y = y + torch.einsum("bihn,bhpn,bih->bihp", Ch, state, torch.exp(cum))
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # (b,q,h)
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhn,bjh,bjhp->bhpn", Bh, decay_to_end, xq)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssm_mixer(p: dict, u: torch.Tensor, cfg: ModelConfig, *,
              use_kernel: bool = False) -> torch.Tensor:
    """Full Mamba2 mixer: u (B, S, D) -> (B, S, D)."""
    s_cfg = cfg.ssm
    z, xbc, dt, d_inner, n_heads = _split_proj(p, u, cfg.d_model, s_cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    gn = s_cfg.n_groups * s_cfg.state_dim
    x, B, C = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    b, s, _ = u.shape
    x = x.reshape(b, s, n_heads, s_cfg.head_dim)
    B = B.reshape(b, s, s_cfg.n_groups, s_cfg.state_dim)
    C = C.reshape(b, s, s_cfg.n_groups, s_cfg.state_dim)
    dt = _softplus(dt.float() + p["dt_bias"])                # (b,s,h)
    A = -torch.exp(p["A_log"])
    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, _ = kops.ssd_scan(x, dt, A, B, C, chunk=s_cfg.chunk_size)
    else:
        chunk = min(s_cfg.chunk_size, s)
        bc = 2 if s_cfg.n_groups > 1 else None
        # on a mesh the heads are split as the head vectors (A_log) are
        y, _ = shard_local(lambda *a: ssd_reference(*a, chunk=chunk),
                           (x, dt, A, B, C),
                           ((0, 2), (0, 2), (None, 0), (0, bc), (0, bc)),
                           ((0, 2), (0, 1)), heads_from=2)
    y = y + p["D"][:, None] * x.float()
    y = y.reshape(b, s, d_inner).to(u.dtype)
    y = layers.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return layers.dense(y, p["out_proj"])


# ---------------------------------------------------------------------------
# decode (recurrent form)
# ---------------------------------------------------------------------------

class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_dim) rolling conv window
    ssd: torch.Tensor     # (B, H, P, N) recurrent state


def init_ssm_state(batch: int, d_model: int, s: SSMConfig, dtype,
                   device) -> SSMState:
    _, n_heads, conv_dim = _dims(d_model, s)
    return SSMState(
        conv=torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        ssd=torch.zeros((batch, n_heads, s.head_dim, s.state_dim),
                        dtype=torch.float32, device=device),
    )


def ssm_decode_step(p: dict, u: torch.Tensor, state: SSMState,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent step: u (B, 1, D).  Returns the output and a new
    state (the input state is not modified)."""
    s_cfg = cfg.ssm
    z, xbc, dt, d_inner, n_heads = _split_proj(p, u, cfg.d_model, s_cfg)
    window = torch.cat([state.conv, xbc], dim=1)             # (B, W, conv)
    conv_out = (window * p["conv_w"]).sum(dim=1, keepdim=True) + p["conv_b"]
    xbc = F.silu(conv_out)                                   # (B, 1, conv)
    new_conv = window[:, 1:, :]

    gn = s_cfg.n_groups * s_cfg.state_dim
    x, B, C = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    b = u.shape[0]
    x = x.reshape(b, n_heads, s_cfg.head_dim)
    B = B.reshape(b, s_cfg.n_groups, s_cfg.state_dim)
    C = C.reshape(b, s_cfg.n_groups, s_cfg.state_dim)
    rep = n_heads // s_cfg.n_groups
    Bh = B.repeat_interleave(rep, dim=1).float()             # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])          # (b,h)
    a = torch.exp(dt * -torch.exp(p["A_log"]))               # (b,h)
    dax = dt[..., None] * x.float()                          # (b,h,p)
    new_ssd = state.ssd * a[..., None, None] + dax[..., None] * Bh[:, :, None, :]
    y = shard_local(lambda st, c: torch.einsum("bhpn,bhn->bhp", st, c),
                    (new_ssd, Ch), ((0, 1), (0, 1)), ((0, 1),))
    y = y + p["D"][:, None] * x.float()
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    y = layers.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return layers.dense(y, p["out_proj"]), SSMState(conv=new_conv, ssd=new_ssd)
