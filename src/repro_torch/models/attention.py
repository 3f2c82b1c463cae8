"""GQA attention (optional QKV bias, sliding window, M-RoPE) and the decode
path over a KV cache, the counterparts of ``repro.models.attention``.  The
full-sequence path goes through ``kernels.ops.flash_attention`` when
``cfg.use_flash_kernel`` (the CUDA kernel on the card, its plain version on
the CPU); otherwise through the einsum reference, chunked over queries
above 1024 tokens.  ``cross_attention`` (the encoder-decoder's) has no
rotation and no mask and, as the reference's, adds no QKV bias even where
the parameters carry one."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.api import ModelConfig
from repro_torch.parallel.dtensor_ops import (dim_shards, shard_local,
                                              shards_dim, split_dim, write_at)

__all__ = ["attn_spec", "attention", "gqa_scores_reference",
           "chunked_attention", "cross_attention", "KVCache", "init_kv_cache",
           "decode_attention"]


def attn_spec(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int,
              qkv_bias: bool, dtype) -> dict:
    """Parameter spec (shape, dtype, init) of one attention, as ``init_attn``."""
    scale = d_model ** -0.5
    p = {
        "wq": ((d_model, num_heads * head_dim), dtype, scale),
        "wk": ((d_model, num_kv_heads * head_dim), dtype, scale),
        "wv": ((d_model, num_kv_heads * head_dim), dtype, scale),
        "wo": ((num_heads * head_dim, d_model), dtype, scale),
    }
    if qkv_bias:
        p["bq"] = ((num_heads * head_dim,), dtype, "zeros")
        p["bk"] = ((num_kv_heads * head_dim,), dtype, "zeros")
        p["bv"] = ((num_kv_heads * head_dim,), dtype, "zeros")
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 num_heads: int, num_kv_heads: int):
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q, k, v = (layers.dense(x, p["wq"]), layers.dense(x, p["wk"]),
               layers.dense(x, p["wv"]))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_dim(q, -1, (num_heads, hd)),
            split_dim(k, -1, (num_kv_heads, hd)),
            split_dim(v, -1, (num_kv_heads, hd)))


def _apply_positional(q, k, positions, cfg: ModelConfig):
    if cfg.mrope_sections is not None:
        q = layers.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _mask(sq: int, t: int, q_start: int, sliding_window: Optional[int], device):
    """(sq, t) causal mask for queries at absolute ``q_start + i``."""
    qpos = torch.arange(sq, device=device)[:, None] + q_start
    kpos = torch.arange(t, device=device)[None, :]
    mask = kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    return mask


def _attend(q, k, v, mask):
    """q (B,S,K,G,hd), k/v (B,T,K,hd): scores in q's dtype cast to float32,
    float32 softmax, probabilities cast back to v's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * hd ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def gqa_scores_reference(q, k, v, *, causal: bool,
                         sliding_window: Optional[int]) -> torch.Tensor:
    """Reference attention: q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).
    Queries occupy the suffix of the keys."""
    b, s, h, hd = q.shape
    t, kheads = k.shape[1], k.shape[2]
    mask = _mask(s, t, t - s, sliding_window, q.device) if causal else None
    out = _attend(split_dim(q, 2, (kheads, h // kheads)), k, v, mask)
    return out.reshape(b, s, h, hd)


def chunked_attention(q, k, v, *, causal: bool, sliding_window: Optional[int],
                      q_chunk: int = 512) -> torch.Tensor:
    """The same function as ``gqa_scores_reference`` over query chunks: the
    score buffer is (b, h, q_chunk, t) instead of (b, h, s, t)."""
    b, s, h, hd = q.shape
    t, kheads = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        return gqa_scores_reference(q, k, v, causal=causal,
                                    sliding_window=sliding_window)
    qg = split_dim(q, 2, (kheads, h // kheads))
    outs = []
    for c0 in range(0, s, q_chunk):
        mask = (_mask(q_chunk, t, c0 + t - s, sliding_window, q.device)
                if causal else None)
        outs.append(_attend(qg[:, c0:c0 + q_chunk], k, v, mask))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def _local_core(core, q, k, v):
    """``core(q, k, v)``; for DTensors on each rank's own batch rows and
    heads (``parallel.dtensor_ops.shard_local``).  Where the KV heads do not
    divide the query heads' shards (GQA's 8 on a model axis of 16), each is
    repeated until they do, so the query heads stay sharded: a rank's block
    of query heads then meets exactly the keys its heads read."""
    shards = dim_shards(q, 2)
    kh = k.shape[2]
    rep = shards // math.gcd(kh, shards)
    if rep > 1 and q.shape[2] % (kh * rep) == 0:
        idx = torch.arange(kh, device=k.device).repeat_interleave(rep)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return shard_local(core, (q, k, v), ((0, 2),) * 3, ((0, 2),))


def attention(p: dict, x: torch.Tensor, positions, cfg: ModelConfig, *,
              num_heads: Optional[int] = None,
              num_kv_heads: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill)."""
    nh = num_heads or cfg.num_heads
    nk = num_kv_heads or cfg.num_kv_heads
    q, k, v = _project_qkv(p, x, cfg, nh, nk)
    if positions is not None:
        q, k = _apply_positional(q, k, positions, cfg)
    if cfg.use_flash_kernel and causal:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True,
                                   sliding_window=cfg.sliding_window)
    else:
        core = chunked_attention if x.shape[1] > 1024 else gqa_scores_reference
        out = _local_core(lambda *a: core(*a, causal=causal,
                                          sliding_window=cfg.sliding_window),
                          q, k, v)
    b, s = x.shape[:2]
    return layers.dense(out.reshape(b, s, -1), p["wo"])


def cross_attention(p: dict, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ModelConfig, num_heads: int,
                    num_kv_heads: int) -> torch.Tensor:
    """Encoder-decoder cross attention: queries from x (B,S,D), keys and
    values from kv_src (B,T,D); no positional rotation, no mask, no bias."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    t = kv_src.shape[1]
    q = split_dim(layers.dense(x, p["wq"]), -1, (num_heads, hd))
    k = split_dim(layers.dense(kv_src, p["wk"]), -1, (num_kv_heads, hd))
    v = split_dim(layers.dense(kv_src, p["wv"]), -1, (num_kv_heads, hd))
    out = _local_core(lambda *a: gqa_scores_reference(
        *a, causal=False, sliding_window=None), q, k, v)
    return layers.dense(out.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor   # (B, T_max, K, hd)
    v: torch.Tensor   # (B, T_max, K, hd)


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device) -> KVCache:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: dict, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, *, num_heads: Optional[int] = None,
                     num_kv_heads: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D) at position ``pos``.

    Writes the new key and value into ``cache`` in place (the reference's
    donated dynamic_update_slice) and attends over the first pos+1 entries;
    the masked tail the reference also carries adds exact zeros only.  A
    DTensor cache whose sequence is sharded is written shard-locally and
    read whole under the mask, as the reference reads it: its slices would
    gather the cache.
    """
    nh = num_heads or cfg.num_heads
    nk = num_kv_heads or cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(p, x, cfg, nh, nk)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions.expand(len(cfg.mrope_sections), b, 1)
    q, k_new = _apply_positional(q, k_new, positions, cfg)
    if shards_dim(cache.k, 1):
        write_at(cache.k, 1, pos, k_new[:, 0].to(cache.k.dtype))
        write_at(cache.v, 1, pos, v_new[:, 0].to(cache.v.dtype))
        keys, values = cache.k, cache.v
    else:
        cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
        keys, values = cache.k[:, :pos + 1], cache.v[:, :pos + 1]
    mask = _mask(1, keys.shape[1], pos, cfg.sliding_window, x.device)
    qg = split_dim(q, 2, (nk, nh // nk))
    if shards_dim(keys, 1):
        out = _attend(qg, keys, values, mask)
    else:
        out = shard_local(_attend, (qg, keys, values, mask),
                          ((0, 2), (0, 2), (0, 2), None), ((0, 2),))
    return layers.dense(out.reshape(b, 1, nh * hd), p["wo"]), cache
