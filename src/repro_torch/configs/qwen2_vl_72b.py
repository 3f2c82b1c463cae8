"""Qwen2-VL-72B text backbone [arXiv:2409.12191].

M-RoPE (sections 16/24/24 over the 64 frequency bands of head_dim 128),
dynamic-resolution vision frontend is a STUB: the model consumes precomputed
patch embeddings (``embeds_input``) plus 3-component M-RoPE position ids.
"""
from repro_torch.models.api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        act="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        embeds_input=True,
        remat="full",
        train_microbatches=1,
        train_parallelism="zero3",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        qkv_bias=True,
        mrope_sections=(4, 2, 2),
        embeds_input=True,
        dtype="float32",
    )
