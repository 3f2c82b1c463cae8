"""granite-4.0-h-small: the sizes of ``granite-4.0-h-small.json`` as the port
takes them, the weights' tree, and the work of one prefill counted from
shapes."""
from __future__ import annotations

import torch

from portbench.lib import peaks
from portbench.lib.weights import Draws, padded


def dims(doc: dict) -> dict:
    port = doc["port"]
    d, heads = doc["hidden_size"], doc["num_attention_heads"]
    experts, top_k = doc["num_local_experts"], doc["num_experts_per_tok"]
    kinds = list(doc["layer_types"])
    if doc["hidden_act"] != "silu" or doc["attention_bias"] \
            or doc["mamba_proj_bias"] or not doc["mamba_conv_bias"] \
            or doc["position_embedding_type"] != "nope" \
            or doc["normalization_function"] != "rmsnorm" \
            or doc["rope_scaling"] is not None or not doc["tie_word_embeddings"]:
        raise ValueError("the reference follows Granite-4.0-H's published switches")
    if len(kinds) != doc["num_hidden_layers"] \
            or set(kinds) - {"mamba", "attention"}:
        raise ValueError("layer_types names one mixer a layer")
    if doc["mamba_n_heads"] * doc["mamba_d_head"] != doc["mamba_expand"] * d:
        raise ValueError("mamba_n_heads * mamba_d_head is not expand * hidden_size")
    if port["capacity_factor"] < experts / top_k:
        raise ValueError("a capacity factor under experts / top-k can drop "
                         "picks; the published routing is dropless")
    return {
        "dtype": port["dtype"], "pad_vocab_multiple": port["pad_vocab_multiple"],
        "capacity_factor": port["capacity_factor"], "dispatch": port["dispatch"],
        "layers": doc["num_hidden_layers"], "layer_types": kinds,
        "d_model": d, "vocab": doc["vocab_size"], "heads": heads,
        "kv_heads": doc["num_key_value_heads"], "head_dim": d // heads,
        "scale": doc["attention_multiplier"], "experts": experts,
        "top_k": top_k, "d_expert": doc["intermediate_size"],
        "d_shared": doc["shared_intermediate_size"],
        "ssm_heads": doc["mamba_n_heads"], "ssm_head_dim": doc["mamba_d_head"],
        "state": doc["mamba_d_state"], "groups": doc["mamba_n_groups"],
        "conv": doc["mamba_d_conv"], "chunk": doc["mamba_chunk_size"],
        "eps": doc["rms_norm_eps"],
        "embedding_multiplier": float(doc["embedding_multiplier"]),
        "residual_multiplier": float(doc["residual_multiplier"]),
        "logits_scaling": float(doc["logits_scaling"]),
        "a_low": port["a_init_range"][0], "a_high": port["a_init_range"][1],
        "dt_min": port["time_step_min"], "dt_max": port["time_step_max"],
        "dt_floor": port["time_step_floor"],
    }


def smoke_dims() -> dict:
    """The same layers at a size the CPU tests run (float32): attention at
    layer 2 of 5; 8 experts of 32 at top 3, dropless at capacity factor
    8 / 3, and a shared expert of 48."""
    return {"dtype": "float32", "pad_vocab_multiple": 1,
            "capacity_factor": 8 / 3, "dispatch": "row", "layers": 5,
            "layer_types": ["mamba", "mamba", "attention", "mamba", "mamba"],
            "d_model": 64, "vocab": 250, "heads": 4, "kv_heads": 2,
            "head_dim": 16, "scale": 1 / 16, "experts": 8, "top_k": 3,
            "d_expert": 32, "d_shared": 48, "ssm_heads": 8, "ssm_head_dim": 16,
            "state": 16, "groups": 1, "conv": 4, "chunk": 16, "eps": 1e-5,
            "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
            "logits_scaling": 16.0, "a_low": 1, "a_high": 16,
            "dt_min": 1e-3, "dt_max": 0.1, "dt_floor": 1e-4}


def port_config(d: dict):
    """The port's ``ModelConfig`` for these sizes: the published layout
    (``configs.granite_4_0_h_small.published_config``: no RoPE, the
    multipliers, renormalised top-k gates, the LM kernels on) with every
    size set from ``d``."""
    import dataclasses

    from repro_torch.configs.granite_4_0_h_small import published_config
    from repro_torch.models.api import MoEConfig, SSMConfig

    if d["ssm_heads"] * d["ssm_head_dim"] % d["d_model"]:
        raise ValueError("the port's Mamba2 width is expand x d_model")
    return dataclasses.replace(
        published_config(), num_layers=d["layers"], d_model=d["d_model"],
        vocab_size=d["vocab"], num_heads=d["heads"], num_kv_heads=d["kv_heads"],
        head_dim=d["head_dim"], norm_eps=d["eps"],
        layer_types=tuple(d["layer_types"]), attention_scale=d["scale"],
        embedding_multiplier=d["embedding_multiplier"],
        residual_multiplier=d["residual_multiplier"],
        logits_scaling=d["logits_scaling"],
        moe=MoEConfig(num_experts=d["experts"], top_k=d["top_k"],
                      d_ff_expert=d["d_expert"],
                      capacity_factor=d["capacity_factor"],
                      dispatch=d["dispatch"], norm_topk_prob=True,
                      d_ff_shared=d["d_shared"]),
        ssm=SSMConfig(state_dim=d["state"], head_dim=d["ssm_head_dim"],
                      expand=d["ssm_heads"] * d["ssm_head_dim"] // d["d_model"],
                      conv_width=d["conv"], chunk_size=d["chunk"],
                      n_groups=d["groups"]),
        dtype=d["dtype"], pad_vocab_multiple=d["pad_vocab_multiple"])


# the spread of the attention scores the draw of wq and wk gives: at the
# published scale 1/128, q and k drawn as the other projections are (std
# d_model ** -0.5) give scores of spread 0.09, so every position attends
# near evenly over all its keys and the attention layers' output all but
# vanishes; trained models attend far less evenly, and at a spread of 4 the
# larger part of a position's weight lies on a few tens of its keys
SCORE_STD = 4.0


def make_weights(d: dict, gen: torch.Generator, device) -> dict:
    """The port's parameter tree (``ssm`` stacked over the Mamba2 layers,
    ``attn`` over the attention layers, ``blocks`` over every layer; no
    ``lm_head``: the head is the embedding), drawn whole leaf by leaf; wq
    and wk so that the scores spread by ``SCORE_STD``."""
    draws = Draws(gen, device)
    dt = getattr(torch, d["dtype"])
    f32 = torch.float32
    L, dm, h = d["layers"], d["d_model"], d["ssm_heads"]
    nm, na = d["layer_types"].count("mamba"), d["layer_types"].count("attention")
    e, f, fs = d["experts"], d["d_expert"], d["d_shared"]
    d_in = h * d["ssm_head_dim"]
    gn = d["groups"] * d["state"]
    inner, kv = d["heads"] * d["head_dim"], d["kv_heads"] * d["head_dim"]
    # q and k each of spread (SCORE_STD / (hd ** 0.5 * scale)) ** 0.5 a
    # channel, so the scores q . k * scale spread by SCORE_STD
    qk = (SCORE_STD / (dm * d["head_dim"] ** 0.5 * d["scale"])) ** 0.5
    return {
        "embed": draws.normal((padded(d["vocab"], d["pad_vocab_multiple"]), dm),
                              0.02, dt),
        "final_norm": draws.normal((dm,), 0.1, dt),
        "ssm": {
            "in_proj": draws.normal((nm, dm, 2 * d_in + 2 * gn + h),
                                    dm ** -0.5, dt),
            "conv_w": draws.normal((nm, d["conv"], d_in + 2 * gn),
                                   d["conv"] ** -0.5, dt),
            "conv_b": draws.normal((nm, d_in + 2 * gn), 0.1, dt),
            "A_log": draws.a_log((nm, h), d["a_low"], d["a_high"]),
            "D": draws.normal((nm, h), 0.1, f32, mean=1.0),
            "dt_bias": draws.dt_bias((nm, h), d["dt_min"], d["dt_max"],
                                     d["dt_floor"]),
            "norm_w": draws.normal((nm, d_in), 0.1, dt),
            "out_proj": draws.normal((nm, d_in, dm), d_in ** -0.5, dt),
        },
        "attn": {"wq": draws.normal((na, dm, inner), qk, dt),
                 "wk": draws.normal((na, dm, kv), qk, dt),
                 "wv": draws.normal((na, dm, kv), dm ** -0.5, dt),
                 "wo": draws.normal((na, inner, dm), inner ** -0.5, dt)},
        "blocks": {
            "ln1": draws.normal((L, dm), 0.1, dt),
            "ln2": draws.normal((L, dm), 0.1, dt),
            "moe": {"router": draws.normal((L, dm, e), dm ** -0.5, f32),
                    "w_gate": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_up": draws.normal((L, e, dm, f), dm ** -0.5, dt),
                    "w_down": draws.normal((L, e, f, dm), f ** -0.5, dt),
                    "shared": {
                        "w_gate": draws.normal((L, dm, fs), dm ** -0.5, dt),
                        "w_up": draws.normal((L, dm, fs), dm ** -0.5, dt),
                        "w_down": draws.normal((L, fs, dm), fs ** -0.5, dt)}},
        },
    }


def work(d: dict, batch: int, seq: int) -> dict:
    """One prefill's work, from shapes: the flop the last-position logits
    need (every Mamba2 and attention projection over every token, the
    float32 router, each token's top-k experts with no padding and the
    shared expert, the head at the last position only, attention's kept
    pairs, the SSD's work), the matmuls' share of it, and (flop, bytes) of
    each flash launch (q, k, v and the output at every head, each once)
    and of each SSD launch (x, dt, A, B, C, y and the final state, each
    once)."""
    t = batch * seq
    dm, h, p, n, g = (d["d_model"], d["ssm_heads"], d["ssm_head_dim"],
                      d["state"], d["groups"])
    d_in = h * p
    hd = d["head_dim"]
    inner, kv = d["heads"] * hd, d["kv_heads"] * hd
    nm, na = d["layer_types"].count("mamba"), d["layer_types"].count("attention")
    mamba = dm * (2 * d_in + 2 * g * n + h) + d_in * dm
    attention = 2 * dm * inner + 2 * dm * kv
    ffn = dm * d["experts"] + d["top_k"] * 3 * dm * d["d_expert"] \
        + 3 * dm * d["d_shared"]
    matmul = 2.0 * t * (nm * mamba + na * attention + d["layers"] * ffn) \
        + 2.0 * batch * dm * d["vocab"]
    act = d["dtype"]
    q_shape = ((batch * d["heads"], seq, hd), act)
    kv_shape = ((batch * d["kv_heads"], seq, hd), act)
    flash = (peaks.flash_work(batch * d["heads"], seq, seq, hd),
             peaks.nbytes(q_shape, kv_shape, kv_shape, q_shape))
    ssd_bytes = peaks.nbytes(((batch, h, seq, p), act), ((batch, h, seq), "float32"),
                             ((h,), "float32"), ((batch, g, seq, n), act),
                             ((batch, g, seq, n), act),
                             ((batch, h, seq, p), "float32"),
                             ((batch, h, p, n), "float32"))
    ssd = (peaks.ssd_work(batch, h, seq, p, n, d["chunk"]), ssd_bytes)
    return {"flop": matmul + na * flash[0] + nm * ssd[0],
            "matmul_flop": matmul, "flash": [flash] * na, "ssd": [ssd] * nm}
