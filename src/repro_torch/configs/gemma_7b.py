"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim 256, tied embeddings."""
from repro_torch.models.api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        act="geglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        remat="full",
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        act="geglu",
        tie_embeddings=True,
        dtype="float32",
    )
