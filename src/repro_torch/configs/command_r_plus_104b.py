"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified].

GQA (8 KV heads), no biases.  (The HF model uses parallel attention+FFN
blocks and logit scaling; we implement the standard sequential residual form
— noted in DESIGN.md as an accepted deviation for an unverified config.)
"""
from repro_torch.models.api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        act="swiglu",
        rope_theta=75_000_000.0,
        remat="full",
        train_microbatches=1,
        train_parallelism="zero3",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
    )
