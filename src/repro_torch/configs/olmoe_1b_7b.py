"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8.  ``config()`` is the
reference's layout (no QK-norm, gates renormalised, capacity 1.25);
``published_config()`` is the published model's."""
import dataclasses

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


def published_config() -> ModelConfig:
    """OLMoE-1B-7B as published (allenai/OLMoE-1B-7B-0924 config.json, HF
    ``OlmoeModel``): 16 layers of 16 heads of 128 (MHA) whose q and k
    projections each pass one RMSNorm over their whole 2048 channels before
    RoPE; 64 SwiGLU experts of 1024 at top 8 of the router's softmax, the
    gates not renormalised (``norm_topk_prob`` false); the head untied, the
    vocabulary's 50304 rows as published.  Dropless: the row dispatch at
    capacity factor 8 = experts / top-k, so a sequence's capacity is its
    length and no pick is dropped.  Not in the registry: ``config()``
    stays the reference's layout."""
    return ModelConfig(
        name="olmoe-1b-7b-published",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        vocab_size=50304,
        act="swiglu",
        qk_norm=True,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      capacity_factor=8.0, dispatch="row",
                      norm_topk_prob=False),
        rope_theta=10_000.0,
        norm_eps=1e-5,
        use_flash_kernel=True,
        pad_vocab_multiple=1,
    )


def published_smoke_config() -> ModelConfig:
    """The published layout at tiny widths (float32): 2 layers, 8 experts of
    48 at top 4 (capacity factor 2 = E / K), 4 heads of 16."""
    return dataclasses.replace(
        published_config(), name="olmoe-1b-7b-published-smoke", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, vocab_size=250,
        dtype="float32",
        moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=48,
                      capacity_factor=2.0, dispatch="row",
                      norm_topk_prob=False))
