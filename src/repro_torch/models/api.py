"""Model configuration (pure data), the counterpart of ``repro.models.api``.

One generic ``ModelConfig`` covers all ten assigned architectures (dense GQA
transformers, MoE, Mamba2/SSD, the Zamba2 hybrid, and the Whisper-style
encoder-decoder), and the port's own ``hybrid_moe`` family (Granite-4.0-H:
a per-layer list of Mamba2 and attention mixers, each followed by the MoE
FFN).  The fields, defaults and ``param_count`` are the reference's, field
for field, but for the port's own switches (the published Zamba2's
``HybridConfig`` fields, ``qk_norm``, ``MoEConfig.norm_topk_prob`` and
``d_ff_shared``, ``layer_types``, ``use_rope``, ``attention_scale`` and the
three multipliers), whose defaults keep the reference's model; only
``activation_dtype`` returns a ``torch.dtype``.  Models are functions
of an explicit parameter tree (nested dicts of layer-stacked tensors, the
reference's layout): see ``repro_torch.models.transformer``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["MoEConfig", "SSMConfig", "HybridConfig", "EncDecConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "row": per-sequence capacity + shard-local dispatch (optimized default)
    # "flat": global flat-token capacity buffer (the paper-era baseline,
    #         kept for the §Perf A/B)
    dispatch: str = "row"
    # the top-k gates divided by their sum (the reference's routing); False
    # keeps them as the softmax gave them (OLMoE's norm_topk_prob=False)
    norm_topk_prob: bool = True
    # width of an always-on SwiGLU expert every token runs, added to the
    # routed experts' output (Granite's shared_mlp); 0: none
    d_ff_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128      # N (SSD state size)
    head_dim: int = 64        # P (channels per SSD head)
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256     # SSD chunk length
    # B/C groups (GQA-like for SSD); the gated RMSNorm before the out
    # projection takes its RMS over each d_inner / n_groups channels, as
    # Mamba2's and Zamba2's RMSNormGated do
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone with a shared attention block applied
    every ``shared_every`` layers (its parameters are shared across uses).

    With ``layer_ids`` set the layout is the published Zamba2's
    [arXiv:2411.15242; HF ``Zamba2Model``] and ``shared_every`` is unused:
    every layer is a Mamba2 layer, and before each layer in ``layer_ids``
    (call k at the k-th of them) one of ``num_blocks`` shared blocks, block
    k mod ``num_blocks``, runs on ``concat([x, e])`` (``e`` the embedding
    output, 2 d_model channels): RMSNorm, attention of ``shared_num_heads``
    heads of 2 d_model / heads back to d_model at softmax scale
    (head_dim / 2) ** -0.5 (HF ``Zamba2Config`` derives all three so),
    RMSNorm, then the exact-GELU gated MLP whose fused gate/up product
    gains call k's rank-``adapter_rank`` term; no residual inside.  Call k's
    own d_model x d_model projection of the block's output is added to that
    layer's Mamba input, not its residual.  The model's ``act`` is unused
    there.  The defaults are the registry's layout."""

    shared_every: int = 6
    shared_num_heads: int = 32
    shared_num_kv_heads: int = 32
    layer_ids: Optional[Tuple[int, ...]] = None
    num_blocks: int = 1
    adapter_rank: int = 0

    @property
    def published(self) -> bool:
        return self.layer_ids is not None

    def attention_width(self, d_model: int) -> int:
        """Channels the shared block's q, k and v read."""
        return 2 * d_model if self.published else d_model

    def head_dim(self, d_model: int) -> int:
        return self.attention_width(d_model) // self.shared_num_heads

    def softmax_scale(self, d_model: int) -> Optional[float]:
        """The shared attention's scale; None: head_dim ** -0.5."""
        return (self.head_dim(d_model) / 2) ** -0.5 if self.published else None


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style.  The audio conv frontend is a stub: the model consumes
    precomputed frame embeddings of shape (batch, enc_len, d_model)."""

    enc_layers: int = 24
    enc_len: int = 1500
    max_dec_len: int = 32_768   # learned decoder position table size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | hybrid_moe
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0            # 0 for attention-free families
    num_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 0
    act: str = "swiglu"           # swiglu | geglu | gelu
    qkv_bias: bool = False
    # RMSNorm over the whole q and k projections (every head together),
    # before RoPE: OLMoE's q_norm and k_norm
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # M-RoPE (qwen2-vl)
    sliding_window: Optional[int] = None               # SWA (mixtral)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    # hybrid_moe: each layer's mixer, "mamba" or "attention", in order
    layer_types: Optional[Tuple[str, ...]] = None
    # rotary embedding of q and k; False: no positional encoding (NoPE)
    use_rope: bool = True
    # the attention's softmax scale; None: head_dim ** -0.5
    attention_scale: Optional[float] = None
    # the embedding output times ``embedding_multiplier``; the logits
    # divided by ``logits_scaling``; in a hybrid_moe block each branch's
    # output times ``residual_multiplier`` before its residual add
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    dtype: str = "bfloat16"       # activation / weight dtype
    remat: str = "none"           # none | full | dots  (scan remat policy)
    # the LM kernels: flash attention, the causal conv, the SSD scan, the
    # gated norm and the RMSNorm on the card, their plain versions on the CPU
    use_flash_kernel: bool = False
    embeds_input: bool = False    # frontend stub: inputs are embeddings
    pad_vocab_multiple: int = 512  # pad embed/logits so vocab shards over TP
    train_microbatches: int = 1    # gradient-accumulation microbatches
    # decode cache in the scan carry (in-place DUS, donation-aliased).
    # False = baseline ys-emitting scan (full cache copy per step, §Perf).
    decode_cache_in_carry: bool = True
    # training parallelism: "fsdp_tp" (2D) or "zero3" (batch+weights over the
    # whole mesh, no TP — adopted for the large dense archs; §Perf it. 5)
    train_parallelism: str = "fsdp_tp"

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_multiple
        if m <= 1:
            return self.vocab_size
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs and for
        checkpoint sizing; exact counts come from the pytree)."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        if self.family in ("dense", "moe", "hybrid", "encdec", "hybrid_moe"):
            attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
                + hd * self.num_heads * d
            if self.qk_norm:
                attn += hd * (self.num_heads + self.num_kv_heads)
        else:
            attn = 0
        if self.moe is not None:
            ff = self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts \
                + 3 * d * self.moe.d_ff_shared
        elif self.d_ff:
            n_mats = 3 if self.act in ("swiglu", "geglu") else 2
            ff = n_mats * d * self.d_ff
        else:
            ff = 0
        if self.family == "hybrid_moe":
            # exact, every leaf of the tree: the two block norms a layer and
            # the final norm, each mixer's conv, A_log, D, dt_bias and
            # gated-norm weights too
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            conv = d_in + 2 * s.n_groups * s.state_dim
            mamba = d * (d_in + conv + n_heads) + (s.conv_width + 1) * conv \
                + 3 * n_heads + d_in + d_in * d
            n_mamba = self.layer_types.count("mamba")
            return total + d + L * (2 * d + ff) + n_mamba * mamba \
                + (L - n_mamba) * attn
        if self.family == "ssm":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            per = d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_heads) \
                + d_in * d + 3 * n_heads
            return total + L * per
        if self.family == "hybrid":
            s = self.ssm or SSMConfig()
            h = self.hybrid or HybridConfig()
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            per = d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_heads) + d_in * d
            if h.published:
                wide, hd = h.attention_width(d), h.head_dim(d)
                q = hd * h.shared_num_heads
                block = wide * (q + 2 * hd * h.shared_num_kv_heads) + q * d \
                    + 3 * d * self.d_ff
                call = h.adapter_rank * (d + 2 * self.d_ff) + d * d
                return total + L * per + h.num_blocks * block \
                    + len(h.layer_ids) * call
            shared = d * hd * h.shared_num_heads * 2 + 2 * d * hd * h.shared_num_kv_heads \
                + (3 * d * self.d_ff if self.d_ff else 0)
            return total + L * per + shared
        per_layer = attn + ff
        if self.family == "encdec":
            e = self.encdec or EncDecConfig()
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = e.enc_layers * (attn + ff)
            dec = L * (2 * attn + ff)
            return total + enc + dec
        return total + L * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        dense_total = self.param_count() - L * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        return dense_total + L * self.moe.top_k * 3 * d * self.moe.d_ff_expert
