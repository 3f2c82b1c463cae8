"""Mixture-of-Experts FFN with capacity-based token dispatch (GShard-style),
the counterpart of ``repro.models.moe``.

Each (token, slot) pair the router picks gets a position within its expert
by an integer running count over the one-hot of the picks; a pair at or
past its expert's capacity is dropped: it contributes nothing to the
output.  The combine gathers each kept pair's expert output and weights it
by its gate, adding over the K slots in slot order.

``moe_ffn`` (row-local capacity ``ceil(S*K*cf/E)`` a sequence) packs the
kept pairs into one buffer of rows ordered by (expert, sequence,
position): a pair's row is its expert's offset, plus the kept picks of its
expert in earlier sequences, plus its position, all from exclusive running
sums of the (B, E) table of kept counts, with no sort and no atomics.  The
expert FFN is one grouped matmul per weight over that buffer
(``F.grouped_mm``, the E group ends a device tensor: no host sync on the
card in bf16, where it is one CUTLASS kernel; in float32 torch loops over
the groups and reads the ends to the host), so it computes the kept rows
and no padding.  Dropped pairs write one spare row past the groups, which
is neither computed nor read.  On a mesh (DTensor rows) ``moe_ffn`` keeps
a buffer of E*cap rows a sequence and a batched matmul over the expert
axis, whose static (E, rows, D) shape DTensor's propagation shards.
``moe_ffn_flat`` keeps one such buffer over all tokens (capacity
``ceil(N*K*cf/E)``); ``moe_ffn_dense`` (decode) runs every expert on every
token and never drops a pair.  With ``MoEConfig.d_ff_shared`` each path
also runs the shared expert (``_shared_expert``), a SwiGLU of that width
over every token whose output the routed picks are added onto (Granite's
``shared_mlp``); with 0 no path changes.

Every kept pair has a buffer row of its own, so the reference's
scatter-add into a zeroed buffer is a plain scatter here, in place (the
same bits: 0 + x is x), one per slot index j as in the reference; only the
spare row takes several writes, and it is never read.  The combine
gathers with ``index_select``, whose backward adds into distinct rows but
for the spare one, whose gradient is dropped.  No sum depends on the order
of concurrent writes, so a train step and its replay are bit-equal.  The
running count is a scan along the innermost axis of the transposed
one-hot.

``ROWS`` counts, from shapes on the host (no device work, no sync), the
(token, expert) pairs each call routes (tokens x top-k), the rows its
experts compute (the packed rows ``min(B*S*K, B*E*cap)`` of the row path,
E x capacity per buffer of the capacity paths, E x tokens on the dense
path; exact wherever nothing can drop) and the calls that took the packed
path (``ragged``).  Under a profiler the row and flat paths mark the
router, the dispatch (into the experts' row layout), the experts and the
combine (from it back) as spans (``repro_torch.spans``), and the shared
expert as ``moe.shared_expert``.

On a mesh the routing, the dispatch and the combine run on each rank's own
rows (``parallel.dtensor_ops.shard_local``), the grouped expert FFN on
DTensor's propagation.  ``moe_ffn_flat``'s running count is global: each
rank counts its own picks from the picks of the ranks before it
(``rank_offsets``), scatters its rows into a buffer of its own (a partial
sum: every kept row is written on one rank only) and the buffer is
all-reduced, as the reference's replicated flat buffer.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.api import MoEConfig
from repro_torch.models.layers import dense
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.dtensor_ops import (fsdp_gather, is_dtensor,
                                              rank_offsets, replicate,
                                              shard_local)

__all__ = ["moe_spec", "moe_ffn", "moe_ffn_flat", "moe_ffn_dense", "ROWS",
           "reset_row_counts"]

# pairs routed, expert rows computed and calls of the packed row path since
# the last reset, read as moe.routed, moe.computed and moe.ragged
ROWS = spans.counter("moe", "routed", "computed", "ragged")


def reset_row_counts() -> None:
    spans.reset_counts("moe")


def _count_rows(routed: int, computed: int) -> None:
    ROWS["routed"] += routed
    ROWS["computed"] += computed


def moe_spec(d_model: int, cfg: MoEConfig, dtype) -> dict:
    """Parameter spec (shape, dtype, init) of one MoE FFN, as ``init_moe``:
    the router is float32 whatever the model dtype.  With ``d_ff_shared``
    the shared expert's ``shared`` (``w_gate``, ``w_up``, ``w_down``)."""
    e, f = cfg.num_experts, cfg.d_ff_expert
    si, so = d_model ** -0.5, f ** -0.5
    p = {
        "router": ((d_model, e), torch.float32, si),
        "w_gate": ((e, d_model, f), dtype, si),
        "w_up": ((e, d_model, f), dtype, si),
        "w_down": ((e, f, d_model), dtype, so),
    }
    fs = cfg.d_ff_shared
    if fs:
        p["shared"] = {"w_gate": ((d_model, fs), dtype, si),
                       "w_up": ((d_model, fs), dtype, si),
                       "w_down": ((fs, d_model), dtype, fs ** -0.5)}
    return p


def _route(p: dict, xf: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (N, D) -> top-k gates (N, K), expert ids (N, K) and the
    Switch load-balancing loss ``E * sum(me * ce)``.  The gates are the
    top-k softmax probabilities, divided by their sum where
    ``cfg.norm_topk_prob`` (the reference's routing), else as they are.
    The two means are sums over the rows divided by N (a mean is its sum
    over the row count, bit for bit), so on a mesh each rank routes its
    own rows and the sums are reduced across the ranks."""
    def local(xl, router):
        probs = torch.softmax(xl.float() @ router, dim=-1)     # (N, E)
        gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
        if cfg.norm_topk_prob:
            gates = gates / gates.sum(dim=-1, keepdim=True)
        picks = F.one_hot(eidx, cfg.num_experts).float().sum(dim=1)
        return gates, eidx, probs.sum(dim=0), picks.sum(dim=0)

    gates, eidx, psum, csum = shard_local(
        local, (xf, p["router"]), ((0, None), (None, None)),
        ((0, None), (0, None), "sum", "sum"))
    n = xf.shape[0]
    aux = cfg.num_experts * ((psum / n) * (csum / n / cfg.top_k)).sum()
    return gates, eidx, aux


def _positions(flat_e: torch.Tensor, e: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pick's position within its expert (..., M): the picks of that
    expert before it along the last axis; and each expert's picks (..., E)."""
    onehot = F.one_hot(flat_e, e).transpose(-1, -2).contiguous()  # (..., E, M)
    run = onehot.cumsum(dim=-1)
    pos = run.gather(-2, flat_e[..., None, :])[..., 0, :] - 1
    return pos, run[..., -1]


def _slots(flat_e: torch.Tensor, e: int, cap: int, before=None
           ) -> torch.Tensor:
    """Buffer row of each pick (..., M): ``expert * cap + position`` where
    the position (the picks of that expert before it along the last axis,
    plus ``before[expert]`` where given) is below ``cap``, else the spare
    row ``e * cap``."""
    pos, _ = _positions(flat_e, e)
    if before is not None:
        pos = pos + before[flat_e]
    return torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))


def _packed_rows(flat_e: torch.Tensor, e: int, cap: int, spare: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pick's row (B, M) in the buffer of kept picks ordered by
    (expert, sequence, position), ``spare`` for a pick at or past ``cap``
    in its sequence (the picks ``_slots`` drops); and the E group ends,
    cumulative, as int32."""
    pos, count = _positions(flat_e, e)
    kept = count.clamp(max=cap)                                  # (B, E)
    per_expert = kept.sum(dim=0)
    ends = per_expert.cumsum(dim=0)
    first = (ends - per_expert) + (kept.cumsum(dim=0) - kept)   # (B, E)
    row = first.gather(1, flat_e) + pos
    return (torch.where(pos < cap, row, torch.full_like(row, spare)),
            ends.to(torch.int32))


def _ffn(mm, x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """The expert FFN with ``mm(rows, weight)`` as each weight's product."""
    if act == "swiglu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
    elif act == "geglu":
        h = F.gelu(mm(x, p["w_gate"]), approximate="tanh") * mm(x, p["w_up"])
    elif act == "gelu":
        h = F.gelu(mm(x, p["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return mm(h, p["w_down"])


def _shared_expert(p: dict, xf: torch.Tensor, cfg: MoEConfig, act: str):
    """The shared expert's output (N, D) on every row of xf (N, D), None
    without one."""
    if not cfg.d_ff_shared:
        return None
    with spans.span("moe.shared_expert"):
        return _ffn(dense, xf, p["shared"], act)


def _experts(bufr: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Grouped expert FFN: bufr (E, C, D) -> (E, C, D), one batched matmul
    per weight over the expert axis.  DTensor weights are gathered over the
    mesh dims that shard the C rows (``parallel.dtensor_ops.fsdp_gather``)."""
    p = {k: fsdp_gather(p[k], bufr, (1,)) for k in ("w_gate", "w_up", "w_down")
         if k in p}
    return _ffn(torch.bmm, bufr, p, act)


def _experts_ragged(xs: torch.Tensor, ends: torch.Tensor, p: dict, act: str
                    ) -> torch.Tensor:
    """Ragged expert FFN: xs (R, D) -> (R, D), rows ``ends[g-1]`` up to
    ``ends[g]`` through expert g, one grouped matmul per weight taking the
    weights as they are held.  Rows past ``ends[-1]`` are not computed:
    their outputs are undefined."""
    return _ffn(lambda a, w: F.grouped_mm(a, w, offs=ends), xs, p, act)


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
    yf = torch.cat([y, y.new_zeros((b, 1, d))], dim=1).reshape(-1, d)
    first = torch.arange(b, device=y.device)[:, None, None] * (ec + 1)
    return _gather_picks(yf, (slot + first).reshape(b * s, k),
                         gates.reshape(b * s, k)).reshape(b, s, d)


@spans.spanned("moe")
def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local capacity MoE: x (B, S, D) -> (out (B, S, D), aux loss).
    Each sequence has its own per-expert capacity; the experts run over the
    kept pairs only (over E*cap padded rows a sequence on a mesh)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(s * k * cfg.capacity_factor / e))
    if is_dtensor(x):
        return _moe_ffn_padded(p, x, cfg, act, cap)
    rows = min(b * s * k, b * e * cap)          # the kept pairs, at most
    _count_rows(b * s * k, rows)
    ROWS["ragged"] += 1

    with spans.span("moe.router"):
        gates, eidx, aux = _route(p, x.reshape(-1, d), cfg)
    with spans.span("moe.dispatch"):
        row, ends = _packed_rows(eidx.reshape(b, s * k), e, cap, rows)
        row = row.reshape(b * s, k)
        xf = x.reshape(b * s, d)
        buf = x.new_empty((rows + 1, d))        # the last row: the spare
        for j in range(k):
            buf.index_put_((row[:, j],), xf)
    with spans.span("moe.experts"):
        y = _experts_ragged(buf[:rows], ends, p, act)
    shared = _shared_expert(p, xf, cfg, act)
    with spans.span("moe.combine"):
        # a token picks an expert once: at cap >= S nothing drops and no
        # pick reads the spare row, which is zeros where one can
        if cap < s:
            y = torch.cat([y, y.new_zeros((1, d))])
        out = _gather_picks(y, row, gates, shared)
    return out.reshape(b, s, d), aux


def _moe_ffn_padded(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on DTensor rows: each sequence's (E*cap + 1, D) buffer
    and a batched matmul over the expert axis."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    rowwise = ((0, None),)
    _count_rows(b * s * k, e * cap * b)

    with spans.span("moe.router"):
        gates_f, eidx_f, aux = _route(p, x.reshape(-1, d), cfg)
    gates, eidx = gates_f.reshape(b, s, k), eidx_f.reshape(b, s, k)
    with spans.span("moe.dispatch"):
        buf, slot = shard_local(lambda xl, el: _dispatch(xl, el, e, cap),
                                (x, eidx), rowwise * 2, rowwise * 2)
        buf = constrain(buf, "batch")
        bufr = buf[:, :e * cap].reshape(b, e, cap, d).transpose(0, 1)
        bufr = bufr.reshape(e, b * cap, d)
    with spans.span("moe.experts"):
        y = _experts(bufr, p, act)
    with spans.span("moe.combine"):
        y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
        y = constrain(y, "batch")
        out = shard_local(_combine, (y, slot, gates), rowwise * 3, rowwise)
    shared = _shared_expert(p, x.reshape(-1, d), cfg, act)
    if shared is not None:
        out = out + shared.reshape(b, s, d)
    return out, aux


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


def _gather_picks(yf: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                  base=None) -> torch.Tensor:
    """Each pick's row of yf (R, D), weighted by its gate, added over the K
    picks in slot order onto ``base`` (N, D; zeros where None): (N, D) for
    slot and gates (N, K)."""
    out = base if base is not None else torch.zeros(
        (slot.shape[0], yf.shape[-1]), dtype=yf.dtype, device=yf.device)
    for j in range(slot.shape[1]):
        out = out + gates[:, j, None].to(yf.dtype) * yf.index_select(0, slot[:, j])
    return out


def _combine_flat(slot: torch.Tensor, gates: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Each pick's expert output y (E, cap, D) at its row, weighted by its
    gate, summed over the K picks: (N, D)."""
    d = y.shape[-1]
    return _gather_picks(torch.cat([y.reshape(-1, d), y.new_zeros((1, d))]),
                         slot, gates)


@spans.spanned("moe")
def moe_ffn_flat(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global capacity MoE: one buffer over all B*S tokens."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = int(math.ceil(n * k * cfg.capacity_factor / e))
    rows = (0, None)
    _count_rows(n * k, e * cap)

    with spans.span("moe.router"):
        gates, eidx, aux = _route(p, xf, cfg)
    with spans.span("moe.dispatch"):
        before = rank_offsets(lambda el: F.one_hot(el, e).sum(dim=(0, 1)),
                              eidx)
        buf, slot = shard_local(
            lambda xl, el, bl: _dispatch_flat(xl, el, bl, e, cap),
            (xf, eidx, before), (rows, rows, None if before is None else rows),
            ("sum", rows))
        # each buffer freed after its last use: at olmoe's prefill_32k on
        # the production mesh one is 43 GB per rank
        bufr = replicate(buf)[:e * cap].reshape(e, cap, d)
        del buf
    with spans.span("moe.experts"):
        y = _experts(bufr, p, act)
    del bufr
    with spans.span("moe.combine"):
        out = shard_local(_combine_flat, (slot, gates, y),
                          (rows, rows, (None, None)), (rows,))
    shared = _shared_expert(p, xf, cfg, act)
    if shared is not None:
        out = out + shared
    return out.reshape(b, s, d), aux


def moe_ffn_dense(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense path (decode): every expert computes on every token, outputs
    weighted by the gates routed to it; the terms are added in x's dtype in
    expert order, as the reference's scan carries them, onto the shared
    expert's output where there is one."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    e = cfg.num_experts
    _count_rows(xf.shape[0] * cfg.top_k, e * xf.shape[0])
    gates, eidx, aux = _route(p, xf, cfg)
    w = torch.zeros((xf.shape[0], e), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        w = w + gates[:, j, None] * F.one_hot(eidx[:, j], e).float()
    y = _experts(xf.expand(e, -1, -1), p, act)                 # (E, N, D)
    terms = w.T[:, :, None].to(x.dtype) * y
    acc = _shared_expert(p, xf, cfg, act)
    if acc is None:
        acc = torch.zeros_like(xf)
    for i in range(e):
        acc = acc + terms[i]
    return acc.reshape(b, s, d), aux
