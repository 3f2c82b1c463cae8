"""Plain float32 reference of the granite-4.0-h-small configuration
(``configs/granite-4.0-h-small.json``; HF ``GraniteMoeHybridModel``): the
embedding times ``embedding_multiplier``, then layers whose mixer is a
Mamba2 mixer (in projection, depthwise causal conv with bias and SiLU,
softplus dt, the SSD recurrence in chunks, the D skip, RMSNorm of y gated
by SiLU(z) over all channels, out projection) or causal attention with no
positional encoding over query heads that share KV heads, at softmax scale
``attention_multiplier``; each mixer's output times
``residual_multiplier`` added to the stream, then a dropless mixture of
SwiGLU experts (each token sent to its top k of the router's float32
logits, the gates the softmax over those k) plus the shared SwiGLU expert,
their sum times ``residual_multiplier`` added to the stream; the final norm
and the head (the embedding's rows) at the last position, over
``logits_scaling``.

Dropless: every pick is computed, whatever the load on its expert.  The
port's capacity dispatch is held to this, so a pick it dropped would show.

A route is a discrete choice: where the last kept and the first left-out
expert of the last position lie within rounding of each other, the bf16
program may choose the other.  ``forward`` reports these margins so that
the check can tell such near ties (``limits/<cell>.json`` ``tie_margin``).

Returns the last position's logits over the vocabulary, one prompt at a
time, layer by layer from the bfloat16 weights upcast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def ssd(x, dt, a, bmat, cmat, chunk: int) -> torch.Tensor:
    """y_t = C_t . S_t with S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T per
    head, float32, in chunks of ``chunk`` steps: within a chunk the
    quadratic form, between chunks the carried state.  x (b, s, h, p),
    dt (b, s, h), a (h,), B/C (b, s, g, n); head i reads group
    i // (h / g)."""
    b, s, h, p = x.shape
    g = bmat.shape[2]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    group = torch.arange(h, device=x.device) // (h // g)
    xdt = x * dt[..., None]
    la = dt * a
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    state = x.new_zeros((b, h, p, bmat.shape[3]))
    out = torch.empty_like(x)
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        cum = la[:, sl].cumsum(1)                            # (b, q, h)
        bh = bmat[:, sl].index_select(2, group)              # (b, q, h, n)
        ch = cmat[:, sl].index_select(2, group)
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (b, i, j, h)
        decay = torch.where(tri[None, :, :, None], diff,
                            torch.full_like(diff, float("-inf"))).exp()
        scores = torch.einsum("bihn,bjhn->bijh", ch, bh) * decay
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt[:, sl])
        y = y + torch.einsum("bihn,bhpn->bihp", ch, state) * cum.exp()[..., None]
        to_end = (cum[:, -1:] - cum).exp()                   # (b, q, h)
        state = state * cum[:, -1].exp()[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhpn", bh * to_end[..., None], xdt[:, sl])
        out[:, sl] = y
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal conv of x (b, s, c) with w (width, c), then SiLU."""
    width, c = w.shape
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))
    out = F.conv1d(xt, w.float().t()[:, None, :], bias.float(), groups=c)
    return F.silu(out.transpose(1, 2))


def mamba2(p: dict, u: torch.Tensor, dims: dict, precision: str):
    b, s, _ = u.shape
    h, hp, n, g = (dims["ssm_heads"], dims["ssm_head_dim"], dims["state"],
                   dims["groups"])
    d_inner = h * hp
    z, xbc, dt = torch.split(common.mm(u, p["in_proj"], precision),
                             (d_inner, d_inner + 2 * g * n, h), dim=-1)
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, bmat, cmat = torch.split(xbc, (d_inner, g * n, g * n), dim=-1)
    x = x.reshape(b, s, h, hp)
    dt = F.softplus(dt + p["dt_bias"].float())
    y = ssd(x, dt, -p["A_log"].float().exp(), bmat.reshape(b, s, g, n),
            cmat.reshape(b, s, g, n), dims["chunk"])
    y = (y + p["D"].float()[:, None] * x).reshape(b, s, d_inner)
    y = common.rms_norm(y * F.silu(z), p["norm_w"], dims["eps"])
    return common.mm(y, p["out_proj"], precision)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale q k^T) v under a causal mask, q (b, s, h, d), k/v
    (b, s, kh, d): query head i reads KV head i // (h / kh).  In blocks of
    query rows."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (b, h, s, d)
    out = torch.empty_like(q)
    for r0 in range(0, s, common.ATTENTION_ROWS):
        r1 = min(r0 + common.ATTENTION_ROWS, s)
        scores = (q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)) * scale
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(r1, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        out[:, :, r0:r1] = torch.softmax(scores, dim=-1) @ v[:, :, :r1]
    return out.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, dims: dict, precision: str):
    """No rotary embedding: q and k as projected."""
    b, s, _ = x.shape
    q = common.mm(x, p["wq"], precision).reshape(b, s, dims["heads"], -1)
    k = common.mm(x, p["wk"], precision).reshape(b, s, dims["kv_heads"], -1)
    v = common.mm(x, p["wv"], precision).reshape(b, s, dims["kv_heads"], -1)
    out = causal_attention(q, k, v, dims["scale"])
    return common.mm(out.reshape(b, s, -1), p["wo"], precision)


def route(logits: torch.Tensor, top_k: int):
    """Gates (N, k), the softmax over the top-k logits, and expert ids
    (N, k), largest first."""
    top, experts = logits.topk(top_k, dim=-1)
    return torch.softmax(top, dim=-1), experts


def tie_margin(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """How far the last kept expert's router probability lies above the
    first one left out, per row: a near tie is a choice that rounding
    can turn."""
    probs = torch.softmax(logits, dim=-1).topk(top_k + 1, dim=-1).values
    return probs[:, top_k - 1] - probs[:, top_k]


def moe(p: dict, x: torch.Tensor, dims: dict, precision: str, margins=None):
    """The routed experts' sum plus the shared expert's output."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = common.mm(xf, p["router"], precision)
    if margins is not None:
        margins.append(tie_margin(logits.reshape(b, s, -1)[:, -1], dims["top_k"]))
    gates, experts = route(logits, dims["top_k"])
    sp = p["shared"]
    out = common.swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"], precision)
    for i in range(dims["experts"]):
        token, slot = torch.nonzero(experts == i, as_tuple=True)
        if token.numel() == 0:
            continue
        y = common.swiglu(xf[token], p["w_gate"][i], p["w_up"][i],
                          p["w_down"][i], precision)
        out.index_add_(0, token, y * gates[token, slot][:, None])
    return out.reshape(b, s, d)


def _prompt(weights: dict, tokens: torch.Tensor, dims: dict, precision: str,
            margins) -> torch.Tensor:
    eps, r = dims["eps"], dims["residual_multiplier"]
    kinds = dims["layer_types"]
    x = weights["embed"][tokens].float() * dims["embedding_multiplier"]
    for i, kind in enumerate(kinds):
        lp = _at(weights["blocks"], i)
        u = common.rms_norm(x, lp["ln1"], eps)
        k = kinds[:i].count(kind)
        if kind == "mamba":
            y = mamba2(_at(weights["ssm"], k), u, dims, precision)
        else:
            y = attention(_at(weights["attn"], k), u, dims, precision)
        h = x + r * y
        x = h + r * moe(lp["moe"], common.rms_norm(h, lp["ln2"], eps), dims,
                        precision, margins)
    return common.last_logits(x, weights, dims["vocab"], eps, precision) \
        / dims["logits_scaling"]


def forward(weights: dict, tokens: torch.Tensor, dims: dict,
            precision: str = "fp32", margins=None) -> torch.Tensor:
    """Last-position logits (b, vocab) of ``tokens`` (b, s), float32, one
    prompt at a time.  ``margins``, a list, receives each layer's
    ``tie_margin`` at the last position (b,)."""
    per_prompt = []
    with common.true_float32():
        out = []
        for row in range(tokens.shape[0]):
            per_prompt.append([])
            out.append(_prompt(weights, tokens[row:row + 1], dims, precision,
                               per_prompt[-1]))
        if margins is not None:
            margins.extend(torch.cat(layer) for layer in zip(*per_prompt))
        return torch.cat(out)
