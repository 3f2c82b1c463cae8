"""mixtral-8x22b: the sizes of ``mixtral-8x22b.json`` as the port takes them,
the weights' tree, and the work of one prefill counted from shapes."""
from __future__ import annotations

import torch

from portbench.lib import peaks
from portbench.lib.weights import Draws, head, padded


def dims(doc: dict) -> dict:
    port = doc["port"]
    heads, experts, top_k = (doc["num_attention_heads"],
                             doc["num_local_experts"], doc["num_experts_per_tok"])
    if doc["sliding_window"] is not None:
        raise ValueError("the reference attends over the whole causal prefix")
    if port["capacity_factor"] < experts / top_k:
        raise ValueError("a capacity factor under experts / top-k can drop "
                         "picks; the published routing is dropless")
    return {
        "registry": port["registry"], "dtype": port["dtype"],
        "pad_vocab_multiple": port["pad_vocab_multiple"],
        "capacity_factor": port["capacity_factor"], "dispatch": port["dispatch"],
        "layers": doc["num_hidden_layers"], "d_model": doc["hidden_size"],
        "vocab": doc["vocab_size"], "heads": heads,
        "kv_heads": doc["num_key_value_heads"],
        "head_dim": doc["hidden_size"] // heads,
        "experts": experts, "top_k": top_k,
        "d_expert": doc["intermediate_size"], "eps": doc["rms_norm_eps"],
        "rope_theta": float(doc["rope_theta"]),
    }


def smoke_dims() -> dict:
    """The same layers at a size the CPU tests run (float32)."""
    return {"registry": "mixtral-8x22b", "dtype": "float32",
            "pad_vocab_multiple": 512, "capacity_factor": 4.0,
            "dispatch": "row", "layers": 2, "d_model": 64, "vocab": 256,
            "heads": 8, "kv_heads": 2, "head_dim": 8, "experts": 8,
            "top_k": 2, "d_expert": 96, "eps": 1e-5, "rope_theta": 1e6}


def port_config(d: dict):
    """The port's ``ModelConfig`` for these sizes: its registry entry with
    every size set from ``d``, no sliding window, the dropless capacity and
    the flash kernel on."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import MoEConfig

    if d["heads"] * d["head_dim"] != d["d_model"]:
        raise ValueError("the port's attention has d_model / heads channels a head")
    return get_config(
        d["registry"], num_layers=d["layers"], d_model=d["d_model"],
        vocab_size=d["vocab"], num_heads=d["heads"], num_kv_heads=d["kv_heads"],
        head_dim=0, act="swiglu", norm_eps=d["eps"], rope_theta=d["rope_theta"],
        sliding_window=None,
        moe=MoEConfig(num_experts=d["experts"], top_k=d["top_k"],
                      d_ff_expert=d["d_expert"],
                      capacity_factor=d["capacity_factor"],
                      dispatch=d["dispatch"]),
        dtype=d["dtype"], use_flash_kernel=True,
        pad_vocab_multiple=d["pad_vocab_multiple"])


def make_weights(d: dict, gen: torch.Generator, device) -> dict:
    """The port's parameter tree (``blocks`` stacked over the layers),
    drawn whole leaf by leaf."""
    draws = Draws(gen, device)
    dt = getattr(torch, d["dtype"])
    L, dm, e, f = d["layers"], d["d_model"], d["experts"], d["d_expert"]
    inner, kv = d["heads"] * d["head_dim"], d["kv_heads"] * d["head_dim"]
    vp = padded(d["vocab"], d["pad_vocab_multiple"])
    return {
        "embed": draws.normal((vp, dm), 0.02, dt),
        "final_norm": draws.normal((dm,), 0.1, dt),
        "lm_head": head(draws, dm, d["vocab"], d["pad_vocab_multiple"], dt),
        "blocks": {
            "ln1": draws.normal((L, dm), 0.1, dt),
            "attn": {"wq": draws.normal((L, dm, inner), dm ** -0.5, dt),
                     "wk": draws.normal((L, dm, kv), dm ** -0.5, dt),
                     "wv": draws.normal((L, dm, kv), dm ** -0.5, dt),
                     "wo": draws.normal((L, inner, dm), inner ** -0.5, dt)},
            "ln2": draws.normal((L, dm), 0.1, dt),
            "moe": {"router": draws.normal((L, dm, e), dm ** -0.5, torch.float32),
                    "w_gate": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_up": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_down": draws.normal((L, e, f, dm), f ** -0.5, dt)},
        },
    }


def work(d: dict, batch: int, seq: int) -> dict:
    """One prefill's work, from shapes: the flop the last-position logits
    need (the projections, the router, each token's top-k experts and no
    capacity padding, the head at the last position only, attention's kept
    pairs), the matmuls' share of it, and (flop, bytes) of each flash
    launch: q and the output at every query head, k and v at the KV heads."""
    t = batch * seq
    dm, hd = d["d_model"], d["head_dim"]
    inner, kv = d["heads"] * hd, d["kv_heads"] * hd
    per_layer = 2.0 * t * (2 * dm * inner + 2 * dm * kv + dm * d["experts"]
                           + d["top_k"] * 3 * dm * d["d_expert"])
    matmul = d["layers"] * per_layer + 2.0 * batch * dm * d["vocab"]
    q_shape = ((batch * d["heads"], seq, hd), d["dtype"])
    kv_shape = ((batch * d["kv_heads"], seq, hd), d["dtype"])
    flash = (peaks.flash_work(batch * d["heads"], seq, seq, hd),
             peaks.nbytes(q_shape, kv_shape, kv_shape, q_shape))
    return {"flop": matmul + d["layers"] * flash[0], "matmul_flop": matmul,
            "flash": [flash] * d["layers"]}
