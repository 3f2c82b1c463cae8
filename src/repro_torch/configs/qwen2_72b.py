"""Qwen2-72B [arXiv:2407.10671]: GQA (8 KV heads), QKV bias."""
from repro_torch.models.api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
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
        remat="full",
        train_microbatches=1,
        train_parallelism="zero3",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        qkv_bias=True,
        dtype="float32",
    )
