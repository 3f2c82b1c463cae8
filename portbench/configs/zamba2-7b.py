"""zamba2-7b: the sizes of ``zamba2-7b.json`` as the port takes them, the
weights' tree, and the work of one prefill counted from shapes."""
from __future__ import annotations

import torch

from portbench.lib import peaks
from portbench.lib.weights import Draws, padded


def dims(doc: dict) -> dict:
    port = doc["port"]
    d, heads = doc["hidden_size"], doc["num_attention_heads"]
    ids = doc["hybrid_layer_ids"]
    if doc["hidden_act"] != "gelu" or doc["add_bias_linear"] \
            or doc["use_shared_attention_adapter"] \
            or not (doc["use_shared_mlp_adapter"] and doc["use_mem_rope"]
                    and doc["use_conv_bias"]) or doc["use_long_context"] \
            or doc["time_step_limit"] is not None:
        raise ValueError("the reference follows Zamba2-7B's published switches")
    if [i for i, t in enumerate(doc["layers_block_type"]) if t == "hybrid"] != ids \
            or len(doc["layers_block_type"]) != doc["num_hidden_layers"]:
        raise ValueError("hybrid_layer_ids are not layers_block_type's hybrids")
    if doc["attention_hidden_size"] != 2 * d \
            or doc["attention_head_dim"] * heads != doc["attention_hidden_size"] \
            or doc["num_key_value_heads"] != heads \
            or doc["intermediate_size"] != doc["ffn_hidden_size"]:
        raise ValueError("the shared block reads concat([x, e]) at 2 d_model")
    d_inner = doc["mamba_expand"] * d
    if doc["n_mamba_heads"] * doc["mamba_headdim"] != d_inner:
        raise ValueError("n_mamba_heads * mamba_headdim is not expand * d_model")
    return {
        "registry": port["registry"], "dtype": port["dtype"],
        "pad_vocab_multiple": port["pad_vocab_multiple"],
        "layers": doc["num_hidden_layers"], "d_model": d,
        "vocab": doc["vocab_size"], "hybrid_ids": list(ids),
        "blocks": doc["num_mem_blocks"], "heads": heads,
        "kv_heads": doc["num_key_value_heads"],
        "head_dim": doc["attention_head_dim"], "d_ff": doc["intermediate_size"],
        "rank": doc["adapter_rank"], "ssm_heads": doc["n_mamba_heads"],
        "ssm_head_dim": doc["mamba_headdim"], "state": doc["mamba_d_state"],
        "groups": doc["mamba_ngroups"], "conv": doc["mamba_d_conv"],
        "chunk": doc["chunk_size"], "eps": doc["rms_norm_eps"],
        "rope_theta": float(doc["rope_theta"]), "a_low": 1, "a_high": 16,
        "dt_min": doc["time_step_min"], "dt_max": doc["time_step_max"],
        "dt_floor": doc["time_step_floor"],
    }


def smoke_dims() -> dict:
    """The same layers at a size the CPU tests run (float32): two blocks
    over four calls, so block 0 serves two calls with their own adapters."""
    return {"registry": "zamba2-7b", "dtype": "float32", "pad_vocab_multiple": 1,
            "layers": 7, "d_model": 64, "vocab": 250, "hybrid_ids": [1, 3, 4, 6],
            "blocks": 2, "heads": 4, "kv_heads": 4, "head_dim": 32, "d_ff": 96,
            "rank": 8, "ssm_heads": 8, "ssm_head_dim": 16, "state": 16,
            "groups": 2, "conv": 4, "chunk": 16, "eps": 1e-5,
            "rope_theta": 1e4, "a_low": 1, "a_high": 16, "dt_min": 1e-3,
            "dt_max": 0.1, "dt_floor": 1e-4}


def port_config(d: dict):
    """The port's ``ModelConfig`` for these sizes: its registry entry with
    the published layout set from ``d``, the head tied, the flash and SSD
    kernels on.  The port derives the shared attention's width, head dim
    and scale from d_model and the heads, as ``Zamba2Config`` does."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import HybridConfig, SSMConfig

    if d["head_dim"] * d["heads"] != 2 * d["d_model"]:
        raise ValueError("the shared heads split 2 d_model channels")

    return get_config(
        d["registry"], num_layers=d["layers"], d_model=d["d_model"],
        vocab_size=d["vocab"], num_heads=d["heads"], num_kv_heads=d["kv_heads"], d_ff=d["d_ff"],
        act="gelu", rope_theta=d["rope_theta"], norm_eps=d["eps"],
        tie_embeddings=True, remat="none", train_microbatches=1,
        ssm=SSMConfig(state_dim=d["state"], head_dim=d["ssm_head_dim"],
                      expand=d["ssm_heads"] * d["ssm_head_dim"] // d["d_model"],
                      conv_width=d["conv"], chunk_size=d["chunk"],
                      n_groups=d["groups"]),
        hybrid=HybridConfig(shared_num_heads=d["heads"],
                            shared_num_kv_heads=d["kv_heads"],
                            layer_ids=tuple(d["hybrid_ids"]),
                            num_blocks=d["blocks"], adapter_rank=d["rank"]),
        dtype=d["dtype"], use_flash_kernel=True,
        pad_vocab_multiple=d["pad_vocab_multiple"])


def make_weights(d: dict, gen: torch.Generator, device) -> dict:
    """The port's parameter tree (``layers`` stacked over the Mamba2 layers,
    ``shared`` over the blocks, ``calls`` over the hybrid layers; no
    ``lm_head``: the head is the embedding), drawn whole leaf by leaf."""
    draws = Draws(gen, device)
    dt = getattr(torch, d["dtype"])
    f32 = torch.float32
    L, dm, h = d["layers"], d["d_model"], d["ssm_heads"]
    nb, nc, r, ff = d["blocks"], len(d["hybrid_ids"]), d["rank"], d["d_ff"]
    d_in = h * d["ssm_head_dim"]
    gn = d["groups"] * d["state"]
    wide, inner = 2 * dm, d["heads"] * d["head_dim"]
    kv = d["kv_heads"] * d["head_dim"]
    return {
        "embed": draws.normal((padded(d["vocab"], d["pad_vocab_multiple"]), dm),
                              0.02, dt),
        "final_norm": draws.normal((dm,), 0.1, dt),
        "layers": {
            "ln": draws.normal((L, dm), 0.1, dt),
            "ssm": {
                "in_proj": draws.normal((L, dm, 2 * d_in + 2 * gn + h),
                                        dm ** -0.5, dt),
                "conv_w": draws.normal((L, d["conv"], d_in + 2 * gn),
                                       d["conv"] ** -0.5, dt),
                "conv_b": draws.normal((L, d_in + 2 * gn), 0.1, dt),
                "A_log": draws.a_log((L, h), d["a_low"], d["a_high"]),
                "D": draws.normal((L, h), 0.1, f32, mean=1.0),
                "dt_bias": draws.dt_bias((L, h), d["dt_min"], d["dt_max"],
                                         d["dt_floor"]),
                "norm_w": draws.normal((L, d_in), 0.1, dt),
                "out_proj": draws.normal((L, d_in, dm), d_in ** -0.5, dt),
            },
        },
        "shared": {
            "ln1": draws.normal((nb, wide), 0.1, dt),
            "attn": {"wq": draws.normal((nb, wide, inner), wide ** -0.5, dt),
                     "wk": draws.normal((nb, wide, kv), wide ** -0.5, dt),
                     "wv": draws.normal((nb, wide, kv), wide ** -0.5, dt),
                     "wo": draws.normal((nb, inner, dm), inner ** -0.5, dt)},
            "ln2": draws.normal((nb, dm), 0.1, dt),
            "mlp": {"w_gate_up": draws.normal((nb, dm, 2 * ff), dm ** -0.5, dt),
                    "w_down": draws.normal((nb, ff, dm), ff ** -0.5, dt)},
        },
        "calls": {
            "lora_a": draws.normal((nc, dm, r), dm ** -0.5, dt),
            "lora_b": draws.normal((nc, r, 2 * ff), r ** -0.5, dt),
            "proj": draws.normal((nc, dm, dm), dm ** -0.5, dt),
        },
    }


def work(d: dict, batch: int, seq: int) -> dict:
    """One prefill's work, from shapes: the flop the last-position logits
    need (every Mamba2 projection and every shared-block product over every
    token, with each call's LoRA and projection; the head at the last
    position only; attention's kept pairs; the SSD's work), the matmuls'
    share of it, and (flop, bytes) of each flash launch (q, k, v and the
    output at every head, each once) and of each SSD launch (x, dt, A, B,
    C, y and the final state, each once)."""
    t = batch * seq
    dm, h, p, n, g = (d["d_model"], d["ssm_heads"], d["ssm_head_dim"],
                      d["state"], d["groups"])
    d_in = h * p
    hd, ff, r = d["head_dim"], d["d_ff"], d["rank"]
    inner, kv, wide = d["heads"] * hd, d["kv_heads"] * hd, 2 * dm
    n_calls = len(d["hybrid_ids"])
    mamba = dm * (2 * d_in + 2 * g * n + h) + d_in * dm
    shared = wide * (inner + 2 * kv) + inner * dm + dm * 2 * ff \
        + r * (dm + 2 * ff) + ff * dm + dm * dm
    matmul = 2.0 * t * (d["layers"] * mamba + n_calls * shared) \
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
    return {"flop": matmul + n_calls * flash[0] + d["layers"] * ssd[0],
            "matmul_flop": matmul, "flash": [flash] * n_calls,
            "ssd": [ssd] * d["layers"]}
