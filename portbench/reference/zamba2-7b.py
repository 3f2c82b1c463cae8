"""Plain float32 reference of the zamba2-7b configuration
(``configs/zamba2-7b.json``), from the published equations (HF
transformers' ``Zamba2Model``; arXiv:2405.16712 eq. 6).

Every layer is a Mamba2 layer: ``x = x + mamba(norm(x + t))``, where ``t``
is zero except at the hybrid layers.  At the k-th hybrid layer ``t`` is
call k's projection of shared block ``k mod blocks`` run on
``concat([x, e])`` (``e`` the embedding output): RMSNorm over the 2 d_model
channels, causal attention of heads of ``head_dim`` with RoPE over every
dim at softmax scale ``(head_dim / 2) ** -0.5``, the output projection back
to d_model, RMSNorm, then ``down(gelu(gate) * up)`` with ``[gate | up] =
x W + (x A_k) B_k`` and exact GELU; no residual inside the block.  The
Mamba2 layer (in projection, depthwise causal conv with bias and SiLU,
softplus dt, the SSD recurrence in chunks, the D skip, RMSNorm of
``y * SiLU(z)`` over each of the ``groups`` groups of channels, out
projection) takes ``ssd`` and ``causal_conv`` from ``mamba2-2.7b.py``.
Then the final norm and the head tied to the embedding, at the last
position.

Returns the last position's logits over the vocabulary, one prefill batch
at a time, layer by layer from the bfloat16 weights upcast; the residual
stream and ``e`` are float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib import spec
from portbench.reference import common

MAMBA2 = spec.load_module(spec.BENCH_DIR / "reference" / "mamba2-2.7b.py",
                          "portbench_reference_zamba2_mamba2_layer")


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def grouped_rms_norm(x: torch.Tensor, w: torch.Tensor, groups: int,
                     eps: float) -> torch.Tensor:
    """``common.rms_norm`` over each of ``groups`` equal groups of the
    last dim (Zamba2's RMSNormGated)."""
    return common.rms_norm(x.unflatten(-1, (groups, -1)),
                           w.unflatten(-1, (groups, -1)), eps).flatten(-2)


def mamba2(p: dict, u: torch.Tensor, dims: dict, precision: str):
    b, s, _ = u.shape
    h, hp, n, g = (dims["ssm_heads"], dims["ssm_head_dim"], dims["state"],
                   dims["groups"])
    d_inner = h * hp
    z, xbc, dt = torch.split(common.mm(u, p["in_proj"], precision),
                             (d_inner, d_inner + 2 * g * n, h), dim=-1)
    xbc = MAMBA2.causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, bmat, cmat = torch.split(xbc, (d_inner, g * n, g * n), dim=-1)
    x = x.reshape(b, s, h, hp)
    dt = F.softplus(dt + p["dt_bias"].float())
    y = MAMBA2.ssd(x, dt, -p["A_log"].float().exp(), bmat.reshape(b, s, g, n),
                   cmat.reshape(b, s, g, n), dims["chunk"])
    y = (y + p["D"].float()[:, None] * x).reshape(b, s, d_inner)
    y = grouped_rms_norm(y * F.silu(z), p["norm_w"], g, dims["eps"])
    return common.mm(y, p["out_proj"], precision)


def shared_block(p: dict, call: dict, x: torch.Tensor, e: torch.Tensor,
                 dims: dict, precision: str) -> torch.Tensor:
    """Call ``call`` of the shared block ``p``: its projected output."""
    b, s, _ = x.shape
    eps, heads, kv_heads = dims["eps"], dims["heads"], dims["kv_heads"]
    u = common.rms_norm(torch.cat([x, e], dim=-1), p["ln1"], eps)
    a = p["attn"]
    q = common.mm(u, a["wq"], precision).reshape(b, s, heads, -1)
    k = common.mm(u, a["wk"], precision).reshape(b, s, kv_heads, -1)
    v = common.mm(u, a["wv"], precision).reshape(b, s, kv_heads, -1)
    # common's attention scales by head_dim ** -0.5; the published scale
    # (head_dim / 2) ** -0.5 is sqrt(2) times that
    q = common.rope(q, dims["rope_theta"]) * 2.0 ** 0.5
    out = common.causal_attention(q, common.rope(k, dims["rope_theta"]), v)
    h = common.rms_norm(common.mm(out.reshape(b, s, -1), a["wo"], precision),
                        p["ln2"], eps)
    m = p["mlp"]
    gate_up = common.mm(h, m["w_gate_up"], precision) + common.mm(
        common.mm(h, call["lora_a"], precision), call["lora_b"], precision)
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    y = common.mm(F.gelu(gate) * up, m["w_down"], precision)
    return common.mm(y, call["proj"], precision)


def forward(weights: dict, tokens: torch.Tensor, dims: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Last-position logits (b, vocab) of ``tokens`` (b, s), float32."""
    eps = dims["eps"]
    calls = {layer: k for k, layer in enumerate(dims["hybrid_ids"])}
    with common.true_float32():
        e = weights["embed"][tokens].float()
        x = e
        for i in range(dims["layers"]):
            lp = _at(weights["layers"], i)
            u = x
            if i in calls:
                k = calls[i]
                u = x + shared_block(_at(weights["shared"], k % dims["blocks"]),
                                     _at(weights["calls"], k), x, e, dims,
                                     precision)
            x = x + mamba2(lp["ssm"], common.rms_norm(u, lp["ln"], eps), dims,
                           precision)
        return common.last_logits(x, weights, dims["vocab"], eps, precision)
