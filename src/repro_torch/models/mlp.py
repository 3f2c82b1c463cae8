"""Feed-forward blocks: SwiGLU (llama family), GeGLU (gemma) and GELU
(whisper), the counterparts of ``repro.models.mlp``.  ``jax.nn.gelu``'s
default is the tanh approximation, hence ``approximate="tanh"``.

``gelu_lora_mlp`` is the published Zamba2's shared MLP (HF ``Zamba2MLP``),
which has no counterpart in the reference: one fused gate/up product plus
the calling layer's low-rank term, exact (erf) GELU of the gate times up,
then down."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.layers import dense

__all__ = ["mlp_spec", "mlp", "gelu_lora_spec", "gelu_lora_mlp"]


def mlp_spec(d_model: int, d_ff: int, act: str, dtype) -> dict:
    """Parameter spec (shape, dtype, init) of one MLP, as ``init_mlp``."""
    p = {
        "w_up": ((d_model, d_ff), dtype, d_model ** -0.5),
        "w_down": ((d_ff, d_model), dtype, d_ff ** -0.5),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = ((d_model, d_ff), dtype, d_model ** -0.5)
    return p


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    elif act == "geglu":
        h = F.gelu(dense(x, p["w_gate"]), approximate="tanh") \
            * dense(x, p["w_up"])
    elif act == "gelu":
        h = F.gelu(dense(x, p["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return dense(h, p["w_down"])


def gelu_lora_spec(d_model: int, d_ff: int, dtype) -> dict:
    """Parameter spec of the shared gated-GELU MLP: ``w_gate_up`` holds the
    gate's columns then up's (the halves ``torch.chunk`` splits)."""
    return {"w_gate_up": ((d_model, 2 * d_ff), dtype, d_model ** -0.5),
            "w_down": ((d_ff, d_model), dtype, d_ff ** -0.5)}


@spans.spanned("shared.mlp")
def gelu_lora_mlp(p: dict, x: torch.Tensor, lora_a: torch.Tensor,
                  lora_b: torch.Tensor) -> torch.Tensor:
    """``down(gelu(gate) * up)`` with ``[gate | up] = x W + (x A) B``: A
    (d_model, rank) and B (rank, 2 d_ff) the calling layer's own.  The
    low-rank term is added in its product's epilogue (``addmm``), with no
    pass of its own over gate/up."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    gate_up = torch.addmm(dense(x2, p["w_gate_up"]), dense(x2, lora_a), lora_b)
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return dense(F.gelu(gate) * up, p["w_down"]).reshape(*lead, -1)
