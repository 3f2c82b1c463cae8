"""Feed-forward blocks: SwiGLU (llama family), GeGLU (gemma) and GELU
(whisper), the counterparts of ``repro.models.mlp``.  ``jax.nn.gelu``'s
default is the tanh approximation, hence ``approximate="tanh"``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense

__all__ = ["mlp_spec", "mlp"]


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
