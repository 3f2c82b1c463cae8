"""Mamba2-370m [arXiv:2405.21060; unverified]: attention-free SSD."""
from repro_torch.models.api import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
        remat="full",
        train_microbatches=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16),
        dtype="float32",
    )
