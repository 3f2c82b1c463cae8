"""olmoe-1b-7b: the sizes of ``olmoe-1b-7b.json`` as the port takes them,
the weights' tree, and the work of one prefill counted from shapes."""
from __future__ import annotations

import torch

from portbench.lib import peaks
from portbench.lib.weights import Draws, head, padded


def dims(doc: dict) -> dict:
    port = doc["port"]
    heads, experts, top_k = (doc["num_attention_heads"], doc["num_experts"],
                             doc["num_experts_per_tok"])
    if doc["hidden_act"] != "silu" or doc["attention_bias"] \
            or doc["clip_qkv"] is not None or doc["rope_scaling"] is not None \
            or doc["tie_word_embeddings"]:
        raise ValueError("the reference follows OLMoE-1B-7B's published switches")
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
        "norm_topk_prob": doc["norm_topk_prob"],
        "d_expert": doc["intermediate_size"], "eps": doc["rms_norm_eps"],
        "rope_theta": float(doc["rope_theta"]),
    }


def smoke_dims() -> dict:
    """The same layers at a size the CPU tests run (float32): 8 experts at
    top 4, dropless at capacity factor 2."""
    return {"registry": "olmoe-1b-7b", "dtype": "float32",
            "pad_vocab_multiple": 1, "capacity_factor": 2.0,
            "dispatch": "row", "layers": 2, "d_model": 64, "vocab": 250,
            "heads": 4, "kv_heads": 4, "head_dim": 16, "experts": 8,
            "top_k": 4, "norm_topk_prob": False, "d_expert": 48,
            "eps": 1e-5, "rope_theta": 1e4}


def port_config(d: dict):
    """The port's ``ModelConfig`` for these sizes: the published layout
    (``configs.olmoe_1b_7b.published_config``: QK-norm, gates as the
    softmax gave them, the flash kernel on) with every size set from
    ``d``."""
    import dataclasses

    from repro_torch.configs.olmoe_1b_7b import published_config
    from repro_torch.models.api import MoEConfig

    if d["heads"] * d["head_dim"] != d["d_model"]:
        raise ValueError("the port's attention has d_model / heads channels a head")
    return dataclasses.replace(
        published_config(), num_layers=d["layers"], d_model=d["d_model"],
        vocab_size=d["vocab"], num_heads=d["heads"], num_kv_heads=d["kv_heads"],
        norm_eps=d["eps"], rope_theta=d["rope_theta"],
        moe=MoEConfig(num_experts=d["experts"], top_k=d["top_k"],
                      d_ff_expert=d["d_expert"],
                      capacity_factor=d["capacity_factor"],
                      dispatch=d["dispatch"],
                      norm_topk_prob=d["norm_topk_prob"]),
        dtype=d["dtype"], pad_vocab_multiple=d["pad_vocab_multiple"])


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
                     "wo": draws.normal((L, inner, dm), inner ** -0.5, dt),
                     "q_norm": draws.normal((L, inner), 0.1, dt),
                     "k_norm": draws.normal((L, kv), 0.1, dt)},
            "ln2": draws.normal((L, dm), 0.1, dt),
            "moe": {"router": draws.normal((L, dm, e), dm ** -0.5, torch.float32),
                    "w_gate": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_up": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_down": draws.normal((L, e, f, dm), f ** -0.5, dt)},
        },
    }


def work(d: dict, batch: int, seq: int) -> dict:
    """One prefill's work, from shapes: the flop the last-position logits
    need (the projections, the float32 router, each token's top-k experts
    and no capacity padding, the head at the last position only,
    attention's kept pairs), the matmuls' share of it, and (flop, bytes) of
    each flash launch: q, k, v and the output at every head, each once."""
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
