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

On a mesh (DTensor rows) the routing, the dispatch and the combine run on
each rank's own rows (``parallel.dtensor_ops.shard_local``), the grouped
expert FFN on DTensor's propagation.  ``moe_ffn_flat``'s running count is
global: each rank counts its own picks from the picks of the ranks before
it (``rank_offsets``), scatters its rows into a buffer of its own (a
partial sum: every kept row is written on one rank only) and the buffer is
all-reduced, as the reference's replicated flat buffer.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.api import MoEConfig
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.dtensor_ops import (fsdp_gather, rank_offsets,
                                              replicate, shard_local)

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
    and the Switch load-balancing loss ``E * sum(me * ce)``.  The two means
    are sums over the rows divided by N (a mean is its sum over the row
    count, bit for bit), so on a mesh each rank routes its own rows and
    the sums are reduced across the ranks."""
    def local(xl, router):
        probs = torch.softmax(xl.float() @ router, dim=-1)     # (N, E)
        gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        picks = F.one_hot(eidx, cfg.num_experts).float().sum(dim=1)
        return gates, eidx, probs.sum(dim=0), picks.sum(dim=0)

    gates, eidx, psum, csum = shard_local(
        local, (xf, p["router"]), ((0, None), (None, None)),
        ((0, None), (0, None), "sum", "sum"))
    n = xf.shape[0]
    aux = cfg.num_experts * ((psum / n) * (csum / n / cfg.top_k)).sum()
    return gates, eidx, aux


def _slots(flat_e: torch.Tensor, e: int, cap: int, before=None
           ) -> torch.Tensor:
    """Buffer row of each pick (..., M): ``expert * cap + position`` where
    the position (the picks of that expert before it along the last axis,
    plus ``before[expert]`` where given) is below ``cap``, else the spare
    row ``e * cap``."""
    onehot = F.one_hot(flat_e, e).transpose(-1, -2).contiguous()  # (..., E, M)
    pos = onehot.cumsum(dim=-1).gather(-2, flat_e[..., None, :])[..., 0, :] - 1
    if before is not None:
        pos = pos + before[flat_e]
    return torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))


def _experts(bufr: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Grouped expert FFN: bufr (E, C, D) -> (E, C, D), one batched matmul
    per weight over the expert axis.  DTensor weights are gathered over the
    mesh dims that shard the C rows (``parallel.dtensor_ops.fsdp_gather``)."""
    p = {k: fsdp_gather(p[k], bufr, (1,)) for k in ("w_gate", "w_up", "w_down")
         if k in p}
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


def _dispatch(x: torch.Tensor, eidx: torch.Tensor, e: int, cap: int):
    """Each row's buffer (B, E*cap + 1, D) and each pick's row in it
    (B, S, K)."""
    b, s, d = x.shape
    k = eidx.shape[-1]
    slot = _slots(eidx.reshape(b, s * k), e, cap).reshape(b, s, k)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
    buf = x.new_zeros((b, e * cap + 1, d))
    for j in range(k):
        buf.index_put_((rows, slot[:, :, j]), x)
    return buf, slot


def _combine(y: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor
             ) -> torch.Tensor:
    """Each pick's expert output y (B, E*cap, D) at its row, weighted by
    its gate, summed over the K picks: (B, S, D)."""
    b, ec, d = y.shape
    s, k = slot.shape[1:]
    rows = torch.arange(b, device=y.device)[:, None].expand(b, s)
    yf = torch.cat([y, y.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    flat_slot = slot + rows[..., None] * (ec + 1)               # rows of yf
    out = torch.zeros((b, s, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        picked = yf.index_select(0, flat_slot[:, :, j].reshape(-1))
        out = out + gates[:, :, j, None].to(y.dtype) * picked.reshape(b, s, d)
    return out


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local capacity MoE: x (B, S, D) -> (out (B, S, D), aux loss).
    Each sequence has its own per-expert capacity and buffer."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(s * k * cfg.capacity_factor / e))
    rowwise = ((0, None),)

    gates_f, eidx_f, aux = _route(p, x.reshape(-1, d), cfg)
    gates, eidx = gates_f.reshape(b, s, k), eidx_f.reshape(b, s, k)
    buf, slot = shard_local(lambda xl, el: _dispatch(xl, el, e, cap),
                            (x, eidx), rowwise * 2, rowwise * 2)
    buf = constrain(buf, "batch")
    bufr = buf[:, :e * cap].reshape(b, e, cap, d).transpose(0, 1)
    y = _experts(bufr.reshape(e, b * cap, d), p, act)
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    y = constrain(y, "batch")
    return shard_local(_combine, (y, slot, gates), rowwise * 3, rowwise), aux


def _dispatch_flat(xf: torch.Tensor, eidx: torch.Tensor, before, e: int,
                   cap: int):
    """The flat buffer (E*cap + 1, D) of these rows and each pick's row in
    it (N, K), the picks of earlier rows per expert in ``before``."""
    n, k = eidx.shape
    slot = _slots(eidx.reshape(-1), e, cap,
                  None if before is None else before[0]).reshape(n, k)
    buf = xf.new_zeros((e * cap + 1, xf.shape[1]))
    for j in range(k):
        buf.index_put_((slot[:, j],), xf)
    return buf, slot


def _combine_flat(slot: torch.Tensor, gates: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Each pick's expert output y (E, cap, D) at its row, weighted by its
    gate, summed over the K picks: (N, D)."""
    d = y.shape[-1]
    yf = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))], dim=0)
    out = torch.zeros((slot.shape[0], d), dtype=y.dtype, device=y.device)
    for j in range(slot.shape[1]):
        out = out + gates[:, j, None].to(y.dtype) * yf.index_select(0, slot[:, j])
    return out


def moe_ffn_flat(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global capacity MoE: one buffer over all B*S tokens."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(n * k * cfg.capacity_factor / e))
    rows = (0, None)

    gates, eidx, aux = _route(p, xf, cfg)
    before = rank_offsets(lambda el: F.one_hot(el, e).sum(dim=(0, 1)), eidx)
    buf, slot = shard_local(
        lambda xl, el, bl: _dispatch_flat(xl, el, bl, e, cap),
        (xf, eidx, before), (rows, rows, None if before is None else rows),
        ("sum", rows))
    # each buffer freed after its last use: at olmoe's prefill_32k on the
    # production mesh one is 43 GB per rank
    bufr = replicate(buf)[:e * cap].reshape(e, cap, d)
    del buf
    y = _experts(bufr, p, act)
    del bufr
    out = shard_local(_combine_flat, (slot, gates, y),
                      (rows, rows, (None, None)), (rows,))
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
