"""Decoder-only LM assembly for the dense, moe, ssm and hybrid (Zamba2-style)
families, the counterpart of ``repro.models.transformer``; the
encoder-decoder family is ``repro_torch.models.encdec``.

Parameters are a nested dict of tensors in the reference's layer-stacked
layout (``blocks`` (L, ...); hybrid ``main`` (n_super, every, ...),
``shared`` and ``tail`` (tail, ...)), so a reference parameter tree carries
over leaf for leaf (``params_from_reference``).  The reference scans over
the stacked layers; here a Python loop indexes them.  The dense and moe
models run ``num_layers`` attention blocks (RMSNorm, attention, RMSNorm,
MLP or MoE FFN); the moe forward returns the mean of the layers' auxiliary
losses, in layer order, and its decode runs the dense MoE path
(``moe_ffn_dense``).  The hybrid model runs ``shared_every`` Mamba2
layers, then one application of the weight-shared attention block,
``num_layers // shared_every`` times, then the ragged tail of Mamba2
layers.  With ``HybridConfig.layer_ids`` set it is the published Zamba2
(``_build_published_hybrid``, the equations in ``HybridConfig``'s doc):
``layers`` (L, ...) Mamba2 layers, ``shared`` (num_blocks, ...) blocks used
by turns, ``calls`` (len(layer_ids), ...) each call's LoRA and projection;
the reference has no counterpart, and its sharding rules do not cover it.
Neither has the ``hybrid_moe`` family (Granite-4.0-H, ``_build_hybrid_moe``):
``ModelConfig.layer_types`` names each layer's mixer, a Mamba2 mixer
(``ssm`` (n_mamba, ...)) or attention (``attn`` (n_attention, ...)), and
every layer (``blocks`` (L, ...): both norms and the MoE FFN) runs
``h = x + r * mixer(norm(x))``, ``x' = h + r * moe(norm(h))`` at
``r = residual_multiplier``, with the embedding output times
``embedding_multiplier`` and the logits over ``logits_scaling``; the other
families refuse these three multipliers.

The forward trains: under grad mode ``remat="full"`` (or ``"dots"``, which
has no finer PyTorch policy and recomputes the whole layer too) wraps each
layer in ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
the reference's per-layer ``jax.checkpoint``.  ``train_microbatches``
belongs to the train step (``launch.steps``); ``decode_cache_in_carry``
shapes the reference's jit cache donation and changes nothing here.  The
reference's sharding anchors are kept: ``parallel.constraints.constrain``
on the embedded input ("hidden"), each layer's output ("hidden") and the
logits ("logits"), a no-op without an activation policy.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import spans
from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, mlp, moe, ssm
from repro_torch.models.api import ModelConfig
from repro_torch.parallel.constraints import constrain

__all__ = ["Model", "build_model", "model_spec", "abstract_params",
           "params_from_reference", "SHARED"]

# calls of a published Zamba2 shared block (forward and decode), counted on
# the host; ``spans.counts()`` reads it as ``shared.calls``
SHARED = spans.counter("shared", "calls")
# hybrid_moe layers run (forward and decode) by mixer, counted on the host:
# ``mixers.mamba`` and ``mixers.attention``
MIXERS = spans.counter("mixers", "mamba", "attention")
MIXER_KINDS = ("mamba", "attention")


class Model(NamedTuple):
    config: ModelConfig
    device: torch.device
    init: Callable            # seed or torch.Generator -> params
    forward: Callable         # (params, batch) -> (logits (B, S, V) f32, aux)
    init_cache: Callable      # (batch, max_len) -> cache
    decode_step: Callable     # (params, cache, tokens (B,1), pos) -> (logits, cache)


# ---------------------------------------------------------------------------
# parameter specs: leaf = (shape, dtype, init), init a normal's scale,
# "zeros" or "ones" — the reference's initialisers, shape for shape
# ---------------------------------------------------------------------------

def _attn_block_spec(cfg: ModelConfig, dtype) -> dict:
    """Attention block: a dense or moe layer, the hybrid's shared block."""
    p = {
        "ln1": ((cfg.d_model,), dtype, "zeros"),
        "attn": attn.attn_spec(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, cfg.qkv_bias, dtype,
                               qk_norm=cfg.qk_norm),
        "ln2": ((cfg.d_model,), dtype, "zeros"),
    }
    if cfg.moe is not None:
        p["moe"] = moe.moe_spec(cfg.d_model, cfg.moe, dtype)
    else:
        p["mlp"] = mlp.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _ssm_block_spec(cfg: ModelConfig, dtype) -> dict:
    return {"ln": ((cfg.d_model,), dtype, "zeros"),
            "ssm": ssm.ssm_spec(cfg.d_model, cfg.ssm, dtype)}


def _published_block_spec(cfg: ModelConfig, dtype) -> dict:
    """One shared block of the published Zamba2: q, k and v read
    ``concat([x, e])``, the output projection writes d_model."""
    h, d = cfg.hybrid, cfg.d_model
    wide = h.attention_width(d)
    return {"ln1": ((wide,), dtype, "zeros"),
            "attn": attn.attn_spec(wide, h.shared_num_heads,
                                   h.shared_num_kv_heads, h.head_dim(d),
                                   False, dtype, d_out=d),
            "ln2": ((d,), dtype, "zeros"),
            "mlp": mlp.gelu_lora_spec(d, cfg.d_ff, dtype)}


def _call_spec(cfg: ModelConfig, dtype) -> dict:
    """What each shared-block call has of its own: the MLP's low-rank term
    (``lora_a`` then ``lora_b``) and the projection of the block's output."""
    d, r = cfg.d_model, cfg.hybrid.adapter_rank
    return {"lora_a": ((d, r), dtype, d ** -0.5),
            "lora_b": ((r, 2 * cfg.d_ff), dtype, max(r, 1) ** -0.5),
            "proj": ((d, d), dtype, d ** -0.5)}


def _hybrid_moe_spec(cfg: ModelConfig, dtype) -> dict:
    """The hybrid_moe family's layers: the Mamba2 mixers and the attention
    mixers each stacked over their own layers, the norms and the MoE FFN
    over every layer."""
    kinds = cfg.layer_types or ()
    if not kinds or len(kinds) != cfg.num_layers \
            or set(kinds) - set(MIXER_KINDS) or cfg.moe is None:
        raise ValueError(f"layer_types {kinds} must name {cfg.num_layers} "
                         f"mixers of {MIXER_KINDS}, with an MoE FFN")
    d = cfg.d_model
    return {
        "ssm": _stacked(ssm.ssm_spec(d, cfg.ssm, dtype), kinds.count("mamba")),
        "attn": _stacked(attn.attn_spec(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, cfg.qkv_bias,
                                        dtype, qk_norm=cfg.qk_norm),
                         kinds.count("attention")),
        "blocks": _stacked({"ln1": ((d,), dtype, "zeros"),
                            "ln2": ((d,), dtype, "zeros"),
                            "moe": moe.moe_spec(d, cfg.moe, dtype)},
                           cfg.num_layers),
    }


def _embedding_spec(cfg: ModelConfig, dtype) -> dict:
    v, d = cfg.padded_vocab_size, cfg.d_model
    p = {"embed": ((v, d), dtype, 0.02), "final_norm": ((d,), dtype, "zeros")}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((d, v), dtype, d ** -0.5)
    return p


def _is_leaf(x) -> bool:
    return isinstance(x, tuple)


def _stacked(spec: dict, *prefix: int) -> dict:
    return {k: _stacked(v, *prefix) if not _is_leaf(v)
            else (tuple(prefix) + v[0], v[1], v[2]) for k, v in spec.items()}


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    h = cfg.hybrid
    return dataclasses.replace(
        cfg, num_heads=h.shared_num_heads, num_kv_heads=h.shared_num_kv_heads,
        head_dim=h.head_dim(cfg.d_model) if h.published else 0, moe=None)


def model_spec(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, dtypes and initialisers."""
    dtype = cfg.activation_dtype
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_spec
        return encdec_spec(cfg)
    spec = _embedding_spec(cfg, dtype)
    if cfg.family in ("dense", "moe"):
        spec["blocks"] = _stacked(_attn_block_spec(cfg, dtype), cfg.num_layers)
    elif cfg.family == "ssm":
        spec["blocks"] = _stacked(_ssm_block_spec(cfg, dtype), cfg.num_layers)
    elif cfg.family == "hybrid" and cfg.hybrid.published:
        spec["layers"] = _stacked(_ssm_block_spec(cfg, dtype), cfg.num_layers)
        spec["shared"] = _stacked(_published_block_spec(cfg, dtype),
                                  cfg.hybrid.num_blocks)
        spec["calls"] = _stacked(_call_spec(cfg, dtype),
                                 len(cfg.hybrid.layer_ids))
    elif cfg.family == "hybrid_moe":
        spec.update(_hybrid_moe_spec(cfg, dtype))
    elif cfg.family == "hybrid":
        n_super, tail = divmod(cfg.num_layers, cfg.hybrid.shared_every)
        spec["main"] = _stacked(_ssm_block_spec(cfg, dtype), n_super,
                                cfg.hybrid.shared_every)
        spec["shared"] = _attn_block_spec(_shared_cfg(cfg), dtype)
        if tail:
            spec["tail"] = _stacked(_ssm_block_spec(cfg, dtype), tail)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return spec


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage): the counterpart of ``jax.eval_shape(model.init, key)``."""
    def walk(spec):
        return {k: walk(v) if not _is_leaf(v)
                else torch.empty(v[0], dtype=v[1], device="meta")
                for k, v in spec.items()}
    return walk(model_spec(cfg))


def _init_leaf(leaf, gen: torch.Generator, device) -> torch.Tensor:
    shape, dtype, how = leaf
    if how == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if how == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    # one stacked layer at a time: no float32 copy of a whole stack
    n_prefix = max(len(shape) - 2, 0)
    for idx in itertools.product(*(range(n) for n in shape[:n_prefix])):
        draw = torch.randn(shape[n_prefix:], generator=gen, device=device,
                           dtype=torch.float32)
        out[idx] = (draw * how).to(dtype)
    return out


def _init_tree(spec: dict, gen, device) -> dict:
    return {k: _init_tree(v, gen, device) if not _is_leaf(v)
            else _init_leaf(v, gen, device) for k, v in spec.items()}


def _to_tensor(arr, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype)


def _convert(tree, spec, device, path: str) -> dict:
    if set(tree) != set(spec):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                         f"{sorted(spec)}")
    out = {}
    for k, leaf in spec.items():
        where = f"{path}/{k}"
        if not _is_leaf(leaf):
            out[k] = _convert(tree[k], leaf, device, where)
            continue
        arr = tree[k]
        if tuple(np.shape(arr)) != leaf[0]:
            raise ValueError(f"{where}: shape {tuple(np.shape(arr))} != {leaf[0]}")
        out[k] = _to_tensor(arr, leaf[1], device)
    return out


def params_from_reference(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameters from the reference's parameter tree (nested
    dicts of numpy arrays in the reference's stacked layout, e.g.
    ``jax.tree.map(np.asarray, model.init(key))``): the same function,
    leaf for leaf, in each leaf's dtype on ``device``."""
    return _convert(tree, model_spec(cfg), resolve_device(device), "")


def _at(tree, *idx):
    """Index every leaf of a stacked tree (a view per leaf)."""
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` recomputed in the backward (the reference's ``_remat``) when
    grad mode is on and ``cfg.remat`` asks for it; ``fn`` itself otherwise."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(cfg.remat)
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return wrapped


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(p: dict, x, positions, cfg: ModelConfig):
    """Returns the block's output and its MoE auxiliary loss (None for a
    dense MLP)."""
    h = x + attn.attention(p["attn"], layers.model_rms_norm(x, p["ln1"], cfg),
                           positions, cfg)
    z = layers.model_rms_norm(h, p["ln2"], cfg)
    if cfg.moe is None:
        return h + mlp.mlp(p["mlp"], z, cfg.act), None
    fn = moe.moe_ffn if cfg.moe.dispatch == "row" else moe.moe_ffn_flat
    y, aux = fn(p["moe"], z, cfg.moe, cfg.act)
    return h + y, aux


def _attn_block_decode(p: dict, x, kv: attn.KVCache, pos: int,
                       cfg: ModelConfig):
    """One-token attention block; writes the new key and value into the
    layer's cache ``kv`` in place."""
    a, _ = attn.decode_attention(
        p["attn"], layers.model_rms_norm(x, p["ln1"], cfg), kv, pos, cfg)
    x = x + a
    z = layers.model_rms_norm(x, p["ln2"], cfg)
    if cfg.moe is None:
        return x + mlp.mlp(p["mlp"], z, cfg.act)
    y, _ = moe.moe_ffn_dense(p["moe"], z, cfg.moe, cfg.act)
    return x + y


def _ssm_block(p: dict, x, cfg: ModelConfig, extra=None):
    """``x + mixer(norm(x))``; with ``extra`` (a published Zamba2 shared
    block's projected output) ``x + mixer(norm(x + extra))``."""
    u = x if extra is None else x + extra
    return x + ssm.ssm_mixer(p["ssm"], layers.model_rms_norm(u, p["ln"], cfg),
                             cfg)


def _ssm_block_decode(p: dict, x, state: ssm.SSMState, idx: tuple,
                      cfg: ModelConfig, extra=None):
    """One-token SSM block (``extra`` as ``_ssm_block``'s); writes the
    layer's new state into the stacked ``state`` at ``idx`` in place."""
    st = ssm.SSMState(conv=state.conv[idx], ssd=state.ssd[idx])
    u = x if extra is None else x + extra
    y, new = ssm.ssm_decode_step(p["ssm"], layers.model_rms_norm(u, p["ln"], cfg),
                                 st, cfg)
    st.conv.copy_(new.conv)
    st.ssd.copy_(new.ssd)
    return x + y


@spans.spanned("shared")
def _published_block(p: dict, call: dict, x, e, attend: Callable,
                     cfg: ModelConfig):
    """One call of a published Zamba2 shared block on the stream ``x`` and
    the embedding output ``e``: ``proj(mlp(norm(attend(norm([x, e])))))``,
    the call's projection of the block's output (no residual inside).
    ``attend(p_attn, h)`` is the prefill's or the decode's attention."""
    SHARED["calls"] += 1
    a = attend(p["attn"], layers.model_rms_norm(torch.cat([x, e], dim=-1),
                                                p["ln1"], cfg))
    y = mlp.gelu_lora_mlp(p["mlp"], layers.model_rms_norm(a, p["ln2"], cfg),
                          call["lora_a"], call["lora_b"])
    return layers.dense(y, call["proj"])


def _hybrid_moe_block(p: dict, mixer: Callable, x, ffn: Callable,
                      cfg: ModelConfig):
    """``h = x + r * mixer(norm(x))``, then ``h + r * ffn(norm(h))`` (the
    routed and the shared experts), each branch scaled in its add; returns
    the output and the FFN's auxiliary loss."""
    r = cfg.residual_multiplier
    h = x.add(mixer(layers.model_rms_norm(x, p["ln1"], cfg)), alpha=r)
    y, aux = ffn(p["moe"], layers.model_rms_norm(h, p["ln2"], cfg), cfg.moe,
                 cfg.act)
    return h.add(y, alpha=r), aux


def _embed_tokens(params, tokens, cfg: ModelConfig):
    """The embedding's rows at ``tokens`` times ``embedding_multiplier``."""
    x = layers.embed(params["embed"], tokens, cfg.activation_dtype)
    return x if cfg.embedding_multiplier == 1.0 \
        else x * cfg.embedding_multiplier


@spans.spanned("embed")
def _embed_in(params, batch, cfg: ModelConfig):
    dtype = cfg.activation_dtype
    if cfg.embeds_input:
        x = batch["embeds"].to(dtype)
    else:
        x = _embed_tokens(params, batch["tokens"], cfg)
    x = constrain(x, "hidden")
    b, s = x.shape[:2]
    base = torch.arange(s, device=x.device)[None].expand(b, s)
    if cfg.mrope_sections is not None:
        positions = batch.get("mrope_positions")
        if positions is None:
            positions = base[None].expand(len(cfg.mrope_sections), b, s)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = base
    return x, positions


@spans.spanned("head")
def _logits_out(params, x, cfg: ModelConfig):
    x = layers.model_rms_norm(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.dense(x, head.to(x.dtype)).float()
    if cfg.logits_scaling != 1.0:
        logits = logits.div_(cfg.logits_scaling)
    return constrain(logits, "logits")


def _ssm_cache(prefix: tuple, batch: int, cfg: ModelConfig, device):
    one = ssm.init_ssm_state(batch, cfg.d_model, cfg.ssm, cfg.activation_dtype,
                             device)
    return ssm.SSMState(*(t.expand(prefix + t.shape).clone() for t in one))


def _seeded(seed_or_gen: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != device.type:
            raise ValueError(f"generator on {seed_or_gen.device}, model on {device}")
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _build_decoder(cfg: ModelConfig, device: torch.device) -> Model:
    """The dense and moe families."""
    n_layers = cfg.num_layers

    def init(seed_or_gen):
        return _init_tree(model_spec(cfg), _seeded(seed_or_gen, device), device)

    def forward(params, batch):
        x, positions = _embed_in(params, batch, cfg)
        layer = _remat(lambda lp, h: _attn_block(lp, h, positions, cfg), cfg)
        auxes = []
        for i in range(n_layers):
            x, aux = layer(_at(params["blocks"], i), x)
            x = constrain(x, "hidden")
            auxes.append(aux)
        if cfg.moe is None:
            return _logits_out(params, x, cfg), torch.zeros((), device=device)
        return _logits_out(params, x, cfg), torch.stack(auxes).mean()

    def init_cache(batch, max_len):
        kv = attn.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.resolved_head_dim, cfg.activation_dtype,
                                device)
        return attn.KVCache(*(t.expand((n_layers,) + t.shape).clone()
                              for t in kv))

    def decode_step(params, cache, tokens, pos):
        x = layers.embed(params["embed"], tokens, cfg.activation_dtype)
        for i in range(n_layers):
            x = _attn_block_decode(_at(params["blocks"], i), x,
                                   attn.KVCache(cache.k[i], cache.v[i]), pos,
                                   cfg)
        return _logits_out(params, x, cfg), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)


def _build_ssm_decoder(cfg: ModelConfig, device: torch.device) -> Model:
    n_layers = cfg.num_layers

    def init(seed_or_gen):
        return _init_tree(model_spec(cfg), _seeded(seed_or_gen, device), device)

    def forward(params, batch):
        x, _ = _embed_in(params, batch, cfg)
        layer = _remat(lambda lp, h: _ssm_block(lp, h, cfg), cfg)
        for i in range(n_layers):
            x = constrain(layer(_at(params["blocks"], i), x), "hidden")
        return _logits_out(params, x, cfg), torch.zeros((), device=device)

    def init_cache(batch, max_len):
        return _ssm_cache((n_layers,), batch, cfg, device)

    def decode_step(params, cache, tokens, pos):
        x = layers.embed(params["embed"], tokens, cfg.activation_dtype)
        for i in range(n_layers):
            x = _ssm_block_decode(_at(params["blocks"], i), x, cache, (i,), cfg)
        return _logits_out(params, x, cfg), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)


def _build_hybrid(cfg: ModelConfig, device: torch.device) -> Model:
    every = cfg.hybrid.shared_every
    n_super, tail = divmod(cfg.num_layers, every)
    shared_cfg = _shared_cfg(cfg)

    def init(seed_or_gen):
        return _init_tree(model_spec(cfg), _seeded(seed_or_gen, device), device)

    def forward(params, batch):
        x, positions = _embed_in(params, batch, cfg)
        layer = _remat(lambda lp, h: _ssm_block(lp, h, cfg), cfg)
        for i in range(n_super):
            for j in range(every):
                x = constrain(layer(_at(params["main"], i, j), x), "hidden")
            x, _ = _attn_block(params["shared"], x, positions, shared_cfg)
            x = constrain(x, "hidden")
        for j in range(tail):
            x = constrain(layer(_at(params["tail"], j), x), "hidden")
        return _logits_out(params, x, cfg), torch.zeros((), device=device)

    def init_cache(batch, max_len):
        kv = attn.init_kv_cache(batch, max_len, shared_cfg.num_kv_heads,
                                shared_cfg.resolved_head_dim,
                                cfg.activation_dtype, device)
        cache = {
            "main_ssm": _ssm_cache((n_super, every), batch, cfg, device),
            "shared_kv": attn.KVCache(*(t.expand((n_super,) + t.shape).clone()
                                        for t in kv)),
        }
        if tail:
            cache["tail_ssm"] = _ssm_cache((tail,), batch, cfg, device)
        return cache

    def decode_step(params, cache, tokens, pos):
        x = layers.embed(params["embed"], tokens, cfg.activation_dtype)
        sp = params["shared"]
        for i in range(n_super):
            for j in range(every):
                x = _ssm_block_decode(_at(params["main"], i, j), x,
                                      cache["main_ssm"], (i, j), cfg)
            kv = attn.KVCache(cache["shared_kv"].k[i], cache["shared_kv"].v[i])
            x = _attn_block_decode(sp, x, kv, pos, shared_cfg)
        for j in range(tail):
            x = _ssm_block_decode(_at(params["tail"], j), x, cache["tail_ssm"],
                                  (j,), cfg)
        return _logits_out(params, x, cfg), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)


def _build_published_hybrid(cfg: ModelConfig, device: torch.device) -> Model:
    """The published Zamba2 (``HybridConfig``'s doc): call k runs block
    k mod ``num_blocks`` with its own LoRA and projection before layer
    ``layer_ids[k]``."""
    h = cfg.hybrid
    n_layers = cfg.num_layers
    ids = list(h.layer_ids)
    if not ids or ids != sorted(set(ids)) or ids[0] < 0 \
            or ids[-1] >= n_layers or h.num_blocks < 1:
        raise ValueError(f"layer_ids {h.layer_ids} must rise within "
                         f"{n_layers} layers, over >= 1 blocks")
    call_at = {layer: k for k, layer in enumerate(ids)}
    shared_cfg = _shared_cfg(cfg)
    scale = h.softmax_scale(cfg.d_model)

    def init(seed_or_gen):
        return _init_tree(model_spec(cfg), _seeded(seed_or_gen, device), device)

    def block_and_call(params, k: int):
        return _at(params["shared"], k % h.num_blocks), _at(params["calls"], k)

    def forward(params, batch):
        x, positions = _embed_in(params, batch, cfg)
        e = x

        def attend(p, u):
            return attn.attention(p, u, positions, shared_cfg, scale=scale)

        layer = _remat(lambda lp, x_, t: _ssm_block(lp, x_, cfg, t), cfg)
        shared = _remat(lambda bp, cp, x_: _published_block(
            bp, cp, x_, e, attend, cfg), cfg)
        for i in range(n_layers):
            t = shared(*block_and_call(params, call_at[i]), x) \
                if i in call_at else None
            x = constrain(layer(_at(params["layers"], i), x, t), "hidden")
        return _logits_out(params, x, cfg), torch.zeros((), device=device)

    def init_cache(batch, max_len):
        kv = attn.init_kv_cache(batch, max_len, shared_cfg.num_kv_heads,
                                shared_cfg.resolved_head_dim,
                                cfg.activation_dtype, device)
        return {"ssm": _ssm_cache((n_layers,), batch, cfg, device),
                "shared_kv": attn.KVCache(*(
                    t.expand((len(h.layer_ids),) + t.shape).clone()
                    for t in kv))}

    def decode_step(params, cache, tokens, pos):
        x = layers.embed(params["embed"], tokens, cfg.activation_dtype)
        e = x
        for i in range(n_layers):
            t = None
            if i in call_at:
                k = call_at[i]
                kv = attn.KVCache(cache["shared_kv"].k[k],
                                  cache["shared_kv"].v[k])
                t = _published_block(
                    *block_and_call(params, k), x, e,
                    lambda p, u: attn.decode_attention(
                        p, u, kv, pos, shared_cfg, scale=scale)[0],
                    cfg)
            x = _ssm_block_decode(_at(params["layers"], i), x, cache["ssm"],
                                  (i,), cfg, t)
        return _logits_out(params, x, cfg), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)


def _build_hybrid_moe(cfg: ModelConfig, device: torch.device) -> Model:
    """The hybrid_moe family (the module doc): layer i's mixer is the k-th
    of its kind, k the layers of that kind before it."""
    spec = model_spec(cfg)
    kinds = cfg.layer_types
    nth = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]
    ffn = moe.moe_ffn if cfg.moe.dispatch == "row" else moe.moe_ffn_flat

    def init(seed_or_gen):
        return _init_tree(spec, _seeded(seed_or_gen, device), device)

    def forward(params, batch):
        x, positions = _embed_in(params, batch, cfg)

        def mamba(bp, mp, h):
            return _hybrid_moe_block(
                bp, lambda u: ssm.ssm_mixer(mp, u, cfg), h, ffn, cfg)

        def attention(bp, ap, h):
            return _hybrid_moe_block(
                bp, lambda u: attn.attention(ap, u, positions, cfg), h, ffn,
                cfg)

        layer = {"mamba": _remat(mamba, cfg), "attention": _remat(attention, cfg)}
        mixer = {"mamba": params["ssm"], "attention": params["attn"]}
        auxes = []
        for i, kind in enumerate(kinds):
            MIXERS[kind] += 1
            x, aux = layer[kind](_at(params["blocks"], i),
                                 _at(mixer[kind], nth[i]), x)
            x = constrain(x, "hidden")
            auxes.append(aux)
        return _logits_out(params, x, cfg), torch.stack(auxes).mean()

    def init_cache(batch, max_len):
        kv = attn.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                cfg.resolved_head_dim, cfg.activation_dtype,
                                device)
        n_attn = kinds.count("attention")
        return {"ssm": _ssm_cache((kinds.count("mamba"),), batch, cfg, device),
                "kv": attn.KVCache(*(t.expand((n_attn,) + t.shape).clone()
                                     for t in kv))}

    def decode_step(params, cache, tokens, pos):
        x = _embed_tokens(params, tokens, cfg)

        def mamba_mixer(k: int):
            def run(u):
                st = ssm.SSMState(conv=cache["ssm"].conv[k],
                                  ssd=cache["ssm"].ssd[k])
                y, new = ssm.ssm_decode_step(_at(params["ssm"], k), u, st, cfg)
                st.conv.copy_(new.conv)
                st.ssd.copy_(new.ssd)
                return y
            return run

        def attention_mixer(k: int):
            kv = attn.KVCache(cache["kv"].k[k], cache["kv"].v[k])
            return lambda u: attn.decode_attention(_at(params["attn"], k), u,
                                                   kv, pos, cfg)[0]

        mixers = {"mamba": mamba_mixer, "attention": attention_mixer}
        for i, kind in enumerate(kinds):
            MIXERS[kind] += 1
            x, _ = _hybrid_moe_block(_at(params["blocks"], i),
                                     mixers[kind](nth[i]), x,
                                     moe.moe_ffn_dense, cfg)
        return _logits_out(params, x, cfg), cache

    return Model(cfg, device, init, forward, init_cache, decode_step)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (``"cuda"`` by default; a CUDA
    request without a card raises).  ``decode_step`` updates the cache in
    place and returns it."""
    dev = resolve_device(device)
    if cfg.family != "hybrid_moe" and (cfg.embedding_multiplier,
                                       cfg.residual_multiplier,
                                       cfg.logits_scaling) != (1.0, 1.0, 1.0):
        raise ValueError("embedding_multiplier, residual_multiplier and "
                         "logits_scaling are the hybrid_moe family's, not "
                         f"the {cfg.family!r} family's")
    if cfg.family == "hybrid_moe":
        return _build_hybrid_moe(cfg, dev)
    if cfg.family in ("dense", "moe"):
        return _build_decoder(cfg, dev)
    if cfg.family == "ssm":
        return _build_ssm_decoder(cfg, dev)
    if cfg.family == "hybrid":
        if cfg.hybrid.published:
            return _build_published_hybrid(cfg, dev)
        return _build_hybrid(cfg, dev)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import build_encdec
        return build_encdec(cfg, dev)
    raise ValueError(f"unknown family {cfg.family!r}")
