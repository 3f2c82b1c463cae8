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
layers.

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

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, mlp, moe, ssm
from repro_torch.models.api import ModelConfig
from repro_torch.parallel.constraints import constrain

__all__ = ["Model", "build_model", "model_spec", "abstract_params",
           "params_from_reference"]


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
                               cfg.resolved_head_dim, cfg.qkv_bias, dtype),
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
    return dataclasses.replace(cfg, num_heads=h.shared_num_heads,
                               num_kv_heads=h.shared_num_kv_heads, head_dim=0,
                               moe=None)


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
    h = x + attn.attention(p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps),
                           positions, cfg)
    z = layers.rms_norm(h, p["ln2"], cfg.norm_eps)
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
        p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps), kv, pos, cfg)
    x = x + a
    z = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + mlp.mlp(p["mlp"], z, cfg.act)
    y, _ = moe.moe_ffn_dense(p["moe"], z, cfg.moe, cfg.act)
    return x + y


def _ssm_block(p: dict, x, cfg: ModelConfig):
    return x + ssm.ssm_mixer(p["ssm"], layers.rms_norm(x, p["ln"], cfg.norm_eps),
                             cfg, use_kernel=cfg.use_flash_kernel)


def _ssm_block_decode(p: dict, x, state: ssm.SSMState, idx: tuple,
                      cfg: ModelConfig):
    """One-token SSM block; writes the layer's new state into the stacked
    ``state`` at ``idx`` in place."""
    st = ssm.SSMState(conv=state.conv[idx], ssd=state.ssd[idx])
    y, new = ssm.ssm_decode_step(p["ssm"], layers.rms_norm(x, p["ln"], cfg.norm_eps),
                                 st, cfg)
    st.conv.copy_(new.conv)
    st.ssd.copy_(new.ssd)
    return x + y


def _embed_in(params, batch, cfg: ModelConfig):
    dtype = cfg.activation_dtype
    if cfg.embeds_input:
        x = batch["embeds"].to(dtype)
    else:
        x = layers.embed(params["embed"], batch["tokens"], dtype)
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


def _logits_out(params, x, cfg: ModelConfig):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(layers.dense(x, head.to(x.dtype)).float(), "logits")


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


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (``"cuda"`` by default; a CUDA
    request without a card raises).  ``decode_step`` updates the cache in
    place and returns it."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return _build_decoder(cfg, dev)
    if cfg.family == "ssm":
        return _build_ssm_decoder(cfg, dev)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg, dev)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import build_encdec
        return build_encdec(cfg, dev)
    raise ValueError(f"unknown family {cfg.family!r}")
