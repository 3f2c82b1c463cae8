"""Mixture-of-Experts FFN with capacity-based token dispatch (GShard-style),
the counterpart of ``repro.models.moe``.

Each (token, slot) pair the router picks gets a position within its expert
by an integer running count over the one-hot of the picks; pairs past an
expert's capacity go to one spare row, which is thrown away.  The grouped
expert FFN is a batched matmul over the expert axis; the combine gathers
each pair's output and weights it by its gate.

Every pair that keeps its slot has a buffer row of its own, so the
reference's scatter-add into a zeroed buffer is a plain scatter here, in
place (the same bits: 0 + x is x), one per slot index j as in the
reference; only the spare row takes several writes, and it is never
read.  The combine
gathers with ``index_select``, whose backward adds into distinct rows but
for the spare one, whose gradient is dropped.  No sum depends on the order
of concurrent writes, so a train step and its replay are bit-equal.  The
running count is a scan along the innermost axis of the transposed
one-hot.  ``moe_ffn`` keeps one buffer per sequence (row-local capacity
``ceil(S*K*cf/E)``), ``moe_ffn_flat`` one buffer over all tokens (capacity
``ceil(N*K*cf/E)``); ``moe_ffn_dense`` (decode) runs every expert on every
token and never drops a pair.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.api import MoEConfig

__all__ = ["moe_spec", "moe_ffn", "moe_ffn_flat", "moe_ffn_dense"]


def moe_spec(d_model: int, cfg: MoEConfig, dtype) -> dict:
    """Parameter spec (shape, dtype, init) of one MoE FFN, as ``init_moe``:
    the router is float32 whatever the model dtype."""
    e, f = cfg.num_experts, cfg.d_ff_expert
    si, so = d_model ** -0.5, f ** -0.5
    return {
        "router": ((d_model, e), torch.float32, si),
        "w_gate": ((e, d_model, f), dtype, si),
        "w_up": ((e, d_model, f), dtype, si),
        "w_down": ((e, f, d_model), dtype, so),
    }


def _route(p: dict, xf: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (N, D) -> top-k gates (N, K) renormalised, expert ids (N, K)
    and the Switch load-balancing loss ``E * sum(me * ce)``."""
    logits = xf.float() @ p["router"]                          # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx, cfg.num_experts).float().sum(dim=1).mean(dim=0) \
        / cfg.top_k
    aux = cfg.num_experts * (me * ce).sum()
    return gates, eidx, aux


def _slots(flat_e: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Buffer row of each pick (..., M): ``expert * cap + position`` where
    the position (the picks of that expert before it along the last axis)
    is below ``cap``, else the spare row ``e * cap``."""
    onehot = F.one_hot(flat_e, e).transpose(-1, -2).contiguous()  # (..., E, M)
    pos = onehot.cumsum(dim=-1).gather(-2, flat_e[..., None, :])[..., 0, :] - 1
    return torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))


def _experts(bufr: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Grouped expert FFN: bufr (E, C, D) -> (E, C, D), one batched matmul
    per weight over the expert axis."""
    if act == "swiglu":
        h = F.silu(torch.bmm(bufr, p["w_gate"])) * torch.bmm(bufr, p["w_up"])
    elif act == "geglu":
        h = F.gelu(torch.bmm(bufr, p["w_gate"]), approximate="tanh") \
            * torch.bmm(bufr, p["w_up"])
    elif act == "gelu":
        h = F.gelu(torch.bmm(bufr, p["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return torch.bmm(h, p["w_down"])


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local capacity MoE: x (B, S, D) -> (out (B, S, D), aux loss).
    Each sequence has its own per-expert capacity and buffer."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(s * k * cfg.capacity_factor / e))

    gates_f, eidx_f, aux = _route(p, x.reshape(-1, d), cfg)
    gates = gates_f.reshape(b, s, k)
    slot = _slots(eidx_f.reshape(b, s * k), e, cap).reshape(b, s, k)

    rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
    buf = x.new_zeros((b, e * cap + 1, d))
    for j in range(k):
        buf.index_put_((rows, slot[:, :, j]), x)
    bufr = buf[:, :e * cap].reshape(b, e, cap, d).transpose(0, 1)
    y = _experts(bufr.reshape(e, b * cap, d), p, act)
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    yf = torch.cat([y, y.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    flat_slot = slot + rows[..., None] * (e * cap + 1)          # rows of yf
    out = torch.zeros_like(x)
    for j in range(k):
        picked = yf.index_select(0, flat_slot[:, :, j].reshape(-1))
        out = out + gates[:, :, j, None].to(x.dtype) * picked.reshape(b, s, d)
    return out, aux


def moe_ffn_flat(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global capacity MoE: one buffer over all B*S tokens."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(n * k * cfg.capacity_factor / e))

    gates, eidx, aux = _route(p, xf, cfg)
    slot = _slots(eidx.reshape(-1), e, cap).reshape(n, k)

    buf = xf.new_zeros((e * cap + 1, d))
    for j in range(k):
        buf.index_put_((slot[:, j],), xf)
    y = _experts(buf[:e * cap].reshape(e, cap, d), p, act)

    yf = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))], dim=0)
    out = torch.zeros_like(xf)
    for j in range(k):
        out = out + gates[:, j, None].to(x.dtype) * yf.index_select(0, slot[:, j])
    return out.reshape(b, s, d), aux


def moe_ffn_dense(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense path (decode): every expert computes on every token, outputs
    weighted by the gates routed to it; the terms are added in x's dtype in
    expert order, as the reference's scan carries them."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    e = cfg.num_experts
    gates, eidx, aux = _route(p, xf, cfg)
    w = torch.zeros((xf.shape[0], e), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        w = w + gates[:, j, None] * F.one_hot(eidx[:, j], e).float()
    y = _experts(xf.expand(e, -1, -1), p, act)                 # (E, N, D)
    terms = w.T[:, :, None].to(x.dtype) * y
    acc = torch.zeros_like(xf)
    for i in range(e):
        acc = acc + terms[i]
    return acc.reshape(b, s, d), aux
