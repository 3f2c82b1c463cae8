"""Mixtral-8x22B [arXiv:2401.04088]: 8 experts top-2, SWA per assignment."""
from repro_torch.models.api import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        vocab_size=32768,
        act="swiglu",
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                      capacity_factor=1.25),
        rope_theta=1_000_000.0,
        remat="full",
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        vocab_size=256,
        act="swiglu",
        sliding_window=32,
        # ample capacity: smoke tests validate decode==forward mechanics,
        # not capacity pressure (tests/test_models.py covers drops)
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=4.0),
        dtype="float32",
    )
