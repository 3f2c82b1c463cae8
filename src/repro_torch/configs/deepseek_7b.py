"""DeepSeek-LLM-7B (llama architecture) [arXiv:2401.02954]."""
from repro_torch.models.api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        act="swiglu",
        rope_theta=10_000.0,
        remat="full",
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
    )
