"""Plain float32 pieces the references share: matrix products (and their
float8 control), RMSNorm, rotary embeddings, causal attention with grouped
KV heads, the SwiGLU feed-forward and the head.  Written from the published
equations; imports nothing of the port or of the JAX package.

Weights are the harness's tensors, read in the port's tree and upcast to
float32 where they are used.  ``precision="fp8"`` is the control: every
matrix product's operands are rounded to float8 e4m3 (per row of the
activations, per output column of the weights, each scaled to e4m3's
largest value) and multiplied in float32, the step below the bfloat16 the
configurations state.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0
ATTENTION_ROWS = 1024       # query rows per block of the attention


@contextlib.contextmanager
def true_float32():
    """float32 products in float32: TF32 off while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32, x (..., K), w (K, N)."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, -2)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the port's weight convention, a ``1 + w`` scale."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (b, s, h, d) at positions 0..s-1, the two
    halves of each head rotated against each other."""
    d, s = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v under a causal mask, q (b, s, h, d), k/v
    (b, s, kh, d): query head i reads KV head i // (h / kh).  In blocks of
    query rows."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (b, h, s, d)
    out = torch.empty_like(q)
    for r0 in range(0, s, ATTENTION_ROWS):
        r1 = min(r0 + ATTENTION_ROWS, s)
        scores = (q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)) / d ** 0.5
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(r1, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        out[:, :, r0:r1] = torch.softmax(scores, dim=-1) @ v[:, :, :r1]
    return out.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, heads: int, kv_heads: int,
              theta: float, precision: str) -> torch.Tensor:
    b, s, _ = x.shape
    q = mm(x, p["wq"], precision).reshape(b, s, heads, -1)
    k = mm(x, p["wk"], precision).reshape(b, s, kv_heads, -1)
    v = mm(x, p["wv"], precision).reshape(b, s, kv_heads, -1)
    out = causal_attention(rope(q, theta), rope(k, theta), v)
    return mm(out.reshape(b, s, -1), p["wo"], precision)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, precision: str):
    return mm(F.silu(mm(x, w_gate, precision)) * mm(x, w_up, precision),
              w_down, precision)


def last_logits(x: torch.Tensor, w: dict, vocab: int, eps: float,
                precision: str) -> torch.Tensor:
    """The final norm and the head at the last position: (b, vocab).  With
    tied embeddings (no ``lm_head``) the head is the embedding's rows."""
    head = w["lm_head"][:, :vocab] if "lm_head" in w \
        else w["embed"][:vocab].t()
    return mm(rms_norm(x[:, -1], w["final_norm"], eps), head, precision)
