"""Zamba2-7B [arXiv:2411.15242; unverified]: Mamba2 backbone with a
weight-shared attention block applied periodically (we use every 6 Mamba
layers; the published model interleaves two shared blocks with LoRA
adapters — simplified to one shared block, noted in DESIGN.md)."""
from repro_torch.models.api import HybridConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        act="swiglu",
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
        hybrid=HybridConfig(shared_every=6, shared_num_heads=32,
                            shared_num_kv_heads=32),
        remat="full",
        train_microbatches=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16),
        hybrid=HybridConfig(shared_every=2, shared_num_heads=4,
                            shared_num_kv_heads=4),
        dtype="float32",
    )
