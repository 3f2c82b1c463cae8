"""Plain float32 reference of the mamba2-2.7b configuration
(``configs/mamba2-2.7b.json``): Mamba2 layers (in projection, depthwise
causal conv with bias and SiLU, softplus dt, the SSD recurrence in chunks,
the D skip, RMSNorm of y gated by SiLU(z), out projection), each after an
RMSNorm and added to the residual stream (kept in float32), then the final
norm and the head tied to the embedding, at the last position.

Returns the last position's logits over the real vocabulary, one prefill
batch at a time, layer by layer from the bfloat16 weights upcast.
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


def forward(weights: dict, tokens: torch.Tensor, dims: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Last-position logits (b, vocab) of ``tokens`` (b, s), float32."""
    eps = dims["eps"]
    with common.true_float32():
        x = weights["embed"][tokens].float()
        for i in range(dims["layers"]):
            lp = _at(weights["blocks"], i)
            x = x + mamba2(lp["ssm"], common.rms_norm(x, lp["ln"], eps),
                           dims, precision)
        return common.last_logits(x, weights, dims["vocab"], eps, precision)
