"""Whisper-medium [arXiv:2212.04356; unverified]: 24+24 layer enc-dec,
d_model 1024, MHA, GELU.  Conv audio frontend is a stub (precomputed frame
embeddings)."""
from repro_torch.models.api import EncDecConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        act="gelu",
        encdec=EncDecConfig(enc_layers=24, enc_len=1500, max_dec_len=32768),
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke",
        family="encdec",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="gelu",
        encdec=EncDecConfig(enc_layers=2, enc_len=32, max_dec_len=128),
        dtype="float32",
    )
