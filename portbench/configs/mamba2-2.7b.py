"""mamba2-2.7b: the sizes of ``mamba2-2.7b.json`` as the port takes them, the
weights' tree, and the work of one prefill counted from shapes."""
from __future__ import annotations

import torch

from portbench.lib import peaks
from portbench.lib.weights import Draws, padded


def dims(doc: dict) -> dict:
    port, layer = doc["port"], doc["ssm_layer"]
    if doc["attn_layer_idx"] or doc["d_intermediate"] or not doc["tie_embeddings"]:
        raise ValueError("the reference is Mamba2 layers alone, the head tied")
    if layer["D_has_hdim"] or layer["norm_before_gate"] or layer["bias"] \
            or not (layer["rmsnorm"] and layer["conv_bias"]):
        raise ValueError("the reference follows the Mamba2 layer's defaults")
    d_inner = layer["expand"] * doc["d_model"]
    if d_inner % layer["headdim"]:
        raise ValueError("expand * d_model is not a multiple of headdim")
    return {
        "registry": port["registry"], "dtype": port["dtype"],
        "pad_vocab_multiple": doc["pad_vocab_size_multiple"],
        "layers": doc["n_layer"], "d_model": doc["d_model"],
        "vocab": doc["vocab_size"], "ssm_heads": d_inner // layer["headdim"],
        "ssm_head_dim": layer["headdim"], "state": layer["d_state"],
        "groups": layer["ngroups"], "conv": layer["d_conv"],
        "chunk": layer["chunk_size"], "eps": layer["norm_epsilon"],
        "a_low": layer["A_init_range"][0], "a_high": layer["A_init_range"][1],
        "dt_min": layer["dt_min"], "dt_max": layer["dt_max"],
        "dt_floor": layer["dt_init_floor"],
    }


def smoke_dims() -> dict:
    """The same layers at a size the CPU tests run (float32)."""
    return {"registry": "mamba2-370m", "dtype": "float32",
            "pad_vocab_multiple": 16, "layers": 3, "d_model": 64,
            "vocab": 250, "ssm_heads": 8, "ssm_head_dim": 16, "state": 32,
            "groups": 1, "conv": 4, "chunk": 16, "eps": 1e-5, "a_low": 1,
            "a_high": 16, "dt_min": 1e-3, "dt_max": 0.1, "dt_floor": 1e-4}


def port_config(d: dict):
    """The port's ``ModelConfig`` for these sizes: its registry entry with
    every size set from ``d``, the head tied, the SSD kernel on."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import SSMConfig

    return get_config(
        d["registry"], num_layers=d["layers"], d_model=d["d_model"],
        vocab_size=d["vocab"], norm_eps=d["eps"], tie_embeddings=True,
        ssm=SSMConfig(state_dim=d["state"], head_dim=d["ssm_head_dim"],
                      expand=d["ssm_heads"] * d["ssm_head_dim"] // d["d_model"],
                      conv_width=d["conv"], chunk_size=d["chunk"],
                      n_groups=d["groups"]),
        dtype=d["dtype"], use_flash_kernel=True,
        pad_vocab_multiple=d["pad_vocab_multiple"])


def make_weights(d: dict, gen: torch.Generator, device) -> dict:
    """The port's parameter tree (``blocks`` stacked over the layers; no
    ``lm_head``: the head is the embedding), drawn whole leaf by leaf."""
    draws = Draws(gen, device)
    dt = getattr(torch, d["dtype"])
    L, dm, h = d["layers"], d["d_model"], d["ssm_heads"]
    d_in = h * d["ssm_head_dim"]
    gn = d["groups"] * d["state"]
    f32 = torch.float32
    return {
        "embed": draws.normal((padded(d["vocab"], d["pad_vocab_multiple"]), dm),
                              0.02, dt),
        "final_norm": draws.normal((dm,), 0.1, dt),
        "blocks": {
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
    }


def work(d: dict, batch: int, seq: int) -> dict:
    """One prefill's work, from shapes: the flop the last-position logits
    need (every projection over every token, the head at the last position
    only, the SSD's work), the matmuls' share of it, and (flop, bytes) of
    each SSD launch: x, dt, A, B, C, y and the final state, each once."""
    t = batch * seq
    dm, h, p, n, g = (d["d_model"], d["ssm_heads"], d["ssm_head_dim"],
                      d["state"], d["groups"])
    d_in = h * p
    layer = 2.0 * t * (dm * (2 * d_in + 2 * g * n + h) + d_in * dm)
    matmul = d["layers"] * layer + 2.0 * batch * dm * d["vocab"]
    act = d["dtype"]
    ssd_bytes = peaks.nbytes(((batch, h, seq, p), act), ((batch, h, seq), "float32"),
                             ((h,), "float32"), ((batch, g, seq, n), act),
                             ((batch, g, seq, n), act),
                             ((batch, h, seq, p), "float32"),
                             ((batch, h, p, n), "float32"))
    ssd = (peaks.ssd_work(batch, h, seq, p, n, d["chunk"]), ssd_bytes)
    return {"flop": matmul + d["layers"] * ssd[0], "matmul_flop": matmul,
            "ssd": [ssd] * d["layers"]}
