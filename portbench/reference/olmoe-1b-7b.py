"""Plain float32 reference of the olmoe-1b-7b configuration
(``configs/olmoe-1b-7b.json``; HF ``OlmoeModel``): layers of causal
attention over 16 heads whose q and k projections each pass one RMSNorm
over all their channels (every head together) before RoPE, then a dropless
mixture of 64 SwiGLU experts, each token sent to its top 8 of the router's
softmax with the 8 gates as the softmax gave them (not renormalised); the
final norm and the head at the last position.

Dropless: every pick is computed, whatever the load on its expert.  The
port's capacity dispatch is held to this, so a pick it dropped would show.

A route is a discrete choice: where the last kept and the first left-out
expert of the last position lie within rounding of each other, the bf16
program may choose the other.  ``forward`` reports these margins so that
the check can tell such near ties (``limits/<cell>.json`` ``tie_margin``).

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
    """Gates (N, k), the top-k softmax probabilities as they are, and
    expert ids (N, k), largest first."""
    return torch.softmax(logits, dim=-1).topk(top_k, dim=-1)


def tie_margin(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """How far the last kept expert's router probability lies above the
    first one left out, per row: a near tie is a choice that rounding
    can turn."""
    probs = torch.softmax(logits, dim=-1).topk(top_k + 1, dim=-1).values
    return probs[:, top_k - 1] - probs[:, top_k]


def attention(p: dict, x: torch.Tensor, dims: dict, precision: str):
    """q and k each normed over their whole width, then split into heads
    and rotated; causal attention; the output projection."""
    b, s, _ = x.shape
    eps, theta = dims["eps"], dims["rope_theta"]
    q = common.rms_norm(common.mm(x, p["wq"], precision), p["q_norm"], eps)
    k = common.rms_norm(common.mm(x, p["wk"], precision), p["k_norm"], eps)
    v = common.mm(x, p["wv"], precision)
    q = common.rope(q.reshape(b, s, dims["heads"], -1), theta)
    k = common.rope(k.reshape(b, s, dims["kv_heads"], -1), theta)
    out = common.causal_attention(q, k, v.reshape(b, s, dims["kv_heads"], -1))
    return common.mm(out.reshape(b, s, -1), p["wo"], precision)


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
            h = x + attention(lp["attn"], common.rms_norm(x, lp["ln1"], eps),
                              dims, precision)
            x = h + moe(lp["moe"], common.rms_norm(h, lp["ln2"], eps), dims,
                        precision, margins)
        return common.last_logits(x, weights, dims["vocab"], eps, precision)
