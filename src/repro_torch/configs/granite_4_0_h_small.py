"""Granite-4.0-H-Small (ibm-granite/granite-4.0-h-small config.json, HF
``GraniteMoeHybridModel``): the port's ``hybrid_moe`` family.  Not in the
registry, which mirrors the JAX package's: ``published_config()`` is the
published model, ``smoke_config()`` its layout at tiny widths."""
import dataclasses

from repro_torch.models.api import ModelConfig, MoEConfig, SSMConfig

# the published layer_types: attention at layers 5, 15, 25 and 35
PUBLISHED_LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                              for i in range(40))


def published_config() -> ModelConfig:
    """40 layers at d_model 4096: 36 Mamba2 mixers (128 SSD heads of 64,
    state 128, one group, conv 4 with bias, chunk 256) and 4 attention
    mixers (32 query heads on 8 KV heads of 128, no positional encoding,
    softmax scale ``attention_multiplier`` 1/128), each followed by 72
    SwiGLU experts of 768 at top 10 (the top-10 router logits' softmax, the
    renormalised top-10 probabilities) plus a shared SwiGLU expert of 1536;
    the embedding times 12, each branch times 0.22 before its residual add,
    the logits over 16; the head tied, 100,352 rows.  Dropless: the row
    dispatch at capacity factor 7.2 = experts / top-k, at which a
    sequence's capacity is its length."""
    return ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid_moe",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        vocab_size=100352,
        act="swiglu",
        norm_eps=1e-5,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768,
                      capacity_factor=7.2, dispatch="row",
                      norm_topk_prob=True, d_ff_shared=1536),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256, n_groups=1),
        layer_types=PUBLISHED_LAYER_TYPES,
        use_rope=False,
        attention_scale=0.0078125,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        use_flash_kernel=True,
        pad_vocab_multiple=512,
    )


def smoke_config() -> ModelConfig:
    """The published layout at tiny widths (float32): 5 layers, attention
    at layer 2; 8 experts of 32 at top 3 (capacity factor 8 / 3 = E / K)
    and a shared expert of 48; 4 query heads on 2 KV heads of 16."""
    return dataclasses.replace(
        published_config(), name="granite-4.0-h-small-smoke", num_layers=5,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=250,
        dtype="float32", pad_vocab_multiple=1, attention_scale=1 / 16,
        layer_types=("mamba", "mamba", "attention", "mamba", "mamba"),
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=32,
                      capacity_factor=8 / 3, dispatch="row",
                      norm_topk_prob=True, d_ff_shared=48),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk_size=16, n_groups=1))
