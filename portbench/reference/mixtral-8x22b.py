"""Plain float32 reference of the mixtral-8x22b configuration
(``configs/mixtral-8x22b.json``): layers of causal attention with RoPE over
48 query heads that share 8 KV heads, then a dropless mixture of 8 SwiGLU
experts, each token sent to its top 2 of the router's softmax with the two
gates renormalised to sum to one; the final norm and the head at the last
position.

Dropless: every pick is computed, whatever the load on its expert.  The
port's capacity dispatch is held to this, so a pick it dropped would show.

A route is a discrete choice: where the last kept and the first left-out
expert of the last position lie within rounding of each other, the bf16
program may choose the other and its answer for that prompt moves by a
large part of its spread.  ``forward`` reports these margins so that the
check can tell such near ties (``limits/<cell>.json`` ``tie_margin``).

Returns the last position's logits over the vocabulary, one prefill batch
at a time, layer by layer from the bfloat16 weights upcast.
"""
from __future__ import annotations

import torch

from portbench.reference import common


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def route(logits: torch.Tensor, top_k: int):
    """Gates (N, k), renormalised, and expert ids (N, k), largest first."""
    top, experts = torch.softmax(logits, dim=-1).topk(top_k, dim=-1)
    return top / top.sum(dim=-1, keepdim=True), experts


def tie_margin(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """How far the last kept expert's router probability lies above the
    first one left out, per row: a near tie is a choice that rounding
    can turn."""
    probs = torch.softmax(logits, dim=-1).topk(top_k + 1, dim=-1).values
    return probs[:, top_k - 1] - probs[:, top_k]


def moe(p: dict, x: torch.Tensor, dims: dict, precision: str, margins=None):
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = common.mm(xf, p["router"], precision)
    if margins is not None:
        margins.append(tie_margin(logits.reshape(b, s, -1)[:, -1], dims["top_k"]))
    gates, experts = route(logits, dims["top_k"])
    out = torch.zeros_like(xf)
    for i in range(dims["experts"]):
        token, slot = torch.nonzero(experts == i, as_tuple=True)
        if token.numel() == 0:
            continue
        y = common.swiglu(xf[token], p["w_gate"][i], p["w_up"][i],
                          p["w_down"][i], precision)
        out.index_add_(0, token, y * gates[token, slot][:, None])
    return out.reshape(b, s, d)


def forward(weights: dict, tokens: torch.Tensor, dims: dict,
            precision: str = "fp32", margins=None) -> torch.Tensor:
    """Last-position logits (b, vocab) of ``tokens`` (b, s), float32.
    ``margins``, a list, receives each layer's ``tie_margin`` at the last
    position (b,)."""
    eps = dims["eps"]
    with common.true_float32():
        x = weights["embed"][tokens].float()
        for i in range(dims["layers"]):
            lp = _at(weights["blocks"], i)
            h = x + common.attention(lp["attn"], common.rms_norm(x, lp["ln1"], eps),
                                     dims["heads"], dims["kv_heads"],
                                     dims["rope_theta"], precision)
            x = h + moe(lp["moe"], common.rms_norm(h, lp["ln2"], eps), dims,
                        precision, margins)
        return common.last_logits(x, weights, dims["vocab"], eps, precision)
