"""Zamba2-7B [arXiv:2411.15242; unverified]: Mamba2 backbone with a
weight-shared attention block applied periodically (we use every 6 Mamba
layers; the published model interleaves two shared blocks with LoRA
adapters — simplified to one shared block, noted in DESIGN.md).  That is
the reference's layout, which ``config()`` keeps; ``published_config()``
is the published model's."""
import dataclasses

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


# the published model's hybrid layers (its config.json's hybrid_layer_ids)
PUBLISHED_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


def published_config() -> ModelConfig:
    """Zamba2-7B as published (Zyphra/Zamba2-7B-Instruct config.json, HF
    ``Zamba2Model``): 81 Mamba2 layers of 112 SSD heads at 2 groups with
    the grouped gated norm, and two shared blocks by turns before the 13
    hybrid layers, on ``concat([x, e])`` (7168 channels), 32 heads of 224
    at scale (224 / 2) ** -0.5, an exact-GELU MLP of 14336 with each call's
    rank-128 LoRA, each call's 3584 x 3584 projection into its Mamba
    layer's input.  The head tied (``Zamba2Config``'s default).  Not in the
    registry: ``config()`` stays the reference's layout."""
    return ModelConfig(
        name="zamba2-7b-published",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        act="gelu",
        rope_theta=10_000.0,
        norm_eps=1e-5,
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256,
                      n_groups=2),
        hybrid=HybridConfig(shared_num_heads=32, shared_num_kv_heads=32,
                            layer_ids=PUBLISHED_LAYER_IDS, num_blocks=2,
                            adapter_rank=128),
    )


def published_smoke_config() -> ModelConfig:
    """The published layout at tiny widths (float32): 7 layers, two blocks
    over four calls, so block 0 serves two calls with their own LoRA."""
    return dataclasses.replace(
        published_config(), name="zamba2-7b-published-smoke", num_layers=7,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=250,
        dtype="float32", pad_vocab_multiple=1,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16,
                      n_groups=2),
        hybrid=HybridConfig(shared_num_heads=4, shared_num_kv_heads=4,
                            layer_ids=(1, 3, 4, 6), num_blocks=2,
                            adapter_rank=8))
