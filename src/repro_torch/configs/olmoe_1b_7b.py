"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8."""
from repro_torch.models.api import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        vocab_size=50304,
        act="swiglu",
        # EP shards the expert axis over "model": the expert-major flat
        # buffer aligns with the expert-sharded weights (the row-local
        # dispatch regressed 4x here; see EXPERIMENTS.md #Perf).
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      capacity_factor=1.25, dispatch="flat"),
        rope_theta=10_000.0,
        remat="full",
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        vocab_size=256,
        act="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      capacity_factor=4.0),
        dtype="float32",
    )
