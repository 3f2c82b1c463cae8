"""Whisper-style encoder-decoder backbone, the counterpart of
``repro.models.encdec``.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (batch, enc_len, d_model).  LayerNorm with
bias (eps 1e-5), GELU MLPs, sinusoidal encoder positions and a learned
decoder position table; attention is MHA with QKV biases.  Two behaviours
are the reference's and kept as they are: the decoder's self-attention
rotates q and k by RoPE on top of the learned positions, and
cross-attention adds no QKV bias although its parameters carry them.  The
encoder's self-attention is non-causal and never reaches the flash kernel;
the decoder's causal self-attention does with ``use_flash_kernel``.
``decode_step`` reads the encoder output from ``cache["enc_out"]`` (zeros
from ``init_cache``; ``encode`` fills it) and recomputes cross-attention
over it at every step.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers, mlp
from repro_torch.models.api import EncDecConfig, ModelConfig
from repro_torch.models.transformer import (Model, _at, _init_tree, _remat,
                                            _seeded, _stacked)
from repro_torch.parallel.constraints import constrain

__all__ = ["encdec_spec", "build_encdec", "encode"]

EPS = 1e-5


def _ln_spec(d: int, dtype) -> dict:
    return {"w": ((d,), dtype, "ones"), "b": ((d,), dtype, "zeros")}


def _ln(x, p):
    return layers.layer_norm(x, p["w"], p["b"], EPS)


def _attn_spec(cfg: ModelConfig, dtype) -> dict:
    return attn.attn_spec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, True, dtype)


def encdec_spec(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, dtypes and initialisers."""
    dtype = cfg.activation_dtype
    e = cfg.encdec or EncDecConfig()
    d = cfg.d_model
    enc_layer = {"ln1": _ln_spec(d, dtype), "attn": _attn_spec(cfg, dtype),
                 "ln2": _ln_spec(d, dtype),
                 "mlp": mlp.mlp_spec(d, cfg.d_ff, "gelu", dtype)}
    dec_layer = {"ln1": _ln_spec(d, dtype), "self_attn": _attn_spec(cfg, dtype),
                 "ln2": _ln_spec(d, dtype), "cross_attn": _attn_spec(cfg, dtype),
                 "ln3": _ln_spec(d, dtype),
                 "mlp": mlp.mlp_spec(d, cfg.d_ff, "gelu", dtype)}
    return {
        "enc_layers": _stacked(enc_layer, e.enc_layers),
        "enc_norm": _ln_spec(d, dtype),
        "dec_layers": _stacked(dec_layer, cfg.num_layers),
        "dec_norm": _ln_spec(d, dtype),
        "embed": ((cfg.padded_vocab_size, d), dtype, 0.02),
        "dec_pos": ((e.max_dec_len, d), dtype, 0.01),
    }


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32 sin | cos table; the timescale step is a
    float32 value, as the reference computes it.  On a card the table is
    the CPU's bits (``layers.host_table``)."""
    if device is not None and torch.device(device).type == "cuda":
        return layers.host_table(_sinusoids, torch.device(device), length,
                                 channels)
    log_timescale = torch.log(torch.tensor(10_000.0, dtype=torch.float32,
                                           device=device)) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _enc_layer(lp: dict, x, cfg: ModelConfig):
    h = x + attn.attention(lp["attn"], _ln(x, lp["ln1"]), None, cfg,
                           causal=False)
    return h + mlp.mlp(lp["mlp"], _ln(h, lp["ln2"]), "gelu")


def _dec_layer(lp: dict, x, enc_out, positions, cfg: ModelConfig):
    h = x + attn.attention(lp["self_attn"], _ln(x, lp["ln1"]), positions, cfg)
    h = h + attn.cross_attention(lp["cross_attn"], _ln(h, lp["ln2"]), enc_out,
                                 cfg, cfg.num_heads, cfg.num_kv_heads)
    return h + mlp.mlp(lp["mlp"], _ln(h, lp["ln3"]), "gelu")


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's output (B, enc_len, D) for frames (B, enc_len, D)."""
    x = frames.to(cfg.activation_dtype)
    x = x + _sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    layer = _remat(lambda lp, h: _enc_layer(lp, h, cfg), cfg)
    for i in range((cfg.encdec or EncDecConfig()).enc_layers):
        x = constrain(layer(_at(params["enc_layers"], i), x), "hidden")
    return _ln(x, params["enc_norm"])


def _logits(params, x):
    x = _ln(x, params["dec_norm"])
    return layers.dense(x, params["embed"].T.to(x.dtype)).float()


def build_encdec(cfg: ModelConfig, device: torch.device) -> Model:
    dtype = cfg.activation_dtype
    e = cfg.encdec or EncDecConfig()
    n_layers = cfg.num_layers

    def init(seed_or_gen):
        return _init_tree(encdec_spec(cfg), _seeded(seed_or_gen, device), device)

    def forward(params, batch):
        """batch: frames (B, enc_len, D) and tokens (B, S)."""
        enc_out = encode(params, batch["frames"], cfg)
        toks = batch["tokens"]
        b, s = toks.shape
        x = layers.embed(params["embed"], toks, dtype)
        x = x + params["dec_pos"][:s][None]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        layer = _remat(lambda lp, h: _dec_layer(lp, h, enc_out, positions, cfg),
                       cfg)
        for i in range(n_layers):
            x = constrain(layer(_at(params["dec_layers"], i), x), "hidden")
        return constrain(_logits(params, x), "logits"), \
            torch.zeros((), device=device)

    def init_cache(batch, max_len):
        kv = attn.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.resolved_head_dim, dtype, device)
        return {"kv": attn.KVCache(*(t.expand((n_layers,) + t.shape).clone()
                                     for t in kv)),
                "enc_out": torch.zeros((batch, e.enc_len, cfg.d_model),
                                       dtype=dtype, device=device)}

    def decode_step(params, cache, tokens, pos):
        pos = int(pos)
        x = layers.embed(params["embed"], tokens, dtype)
        x = x + params["dec_pos"][pos:pos + 1][None]
        enc_out = cache["enc_out"]
        for i in range(n_layers):
            lp = _at(params["dec_layers"], i)
            a, _ = attn.decode_attention(
                lp["self_attn"], _ln(x, lp["ln1"]),
                attn.KVCache(cache["kv"].k[i], cache["kv"].v[i]), pos, cfg)
            x = x + a
            x = x + attn.cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]),
                                         enc_out, cfg, cfg.num_heads,
                                         cfg.num_kv_heads)
            x = x + mlp.mlp(lp["mlp"], _ln(x, lp["ln3"]), "gelu")
        return _logits(params, x), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)
