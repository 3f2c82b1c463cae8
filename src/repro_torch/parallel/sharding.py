"""Sharding rules: partition specs for parameters, batches and decode caches,
the counterpart of ``repro.parallel.sharding``.

Scheme (the reference's):
  * mesh axes ("pod", "data", "model") — "pod" optional;
  * batch is sharded over ("pod", "data");
  * weights are FSDP-sharded over "data" *within* a pod and replicated
    across pods — each pod holds one complete FSDP replica, the
    self-contained uncoordinated-checkpoint group of the paper mapping;
  * tensor parallel over "model": attention heads, FFN hidden, vocab;
  * MoE experts: EP over "model" when num_experts divides the axis
    (olmoe 64e), otherwise TP inside each expert (mixtral 8e on 16);
  * decode caches: batch over the batch axes; the long-context (batch==1)
    shapes shard the KV sequence over ("data","model").

Spec trees are pure data: ``P`` is a tuple with one entry per leading
tensor dim, each ``None``, an axis name or a tuple of axis names, so a tree
compares leaf for leaf with the reference's ``PartitionSpec`` trees (walk
one with ``_tree.items(tree, is_leaf=is_spec)``).  Specs are assigned *by
leaf path* over an abstract tree (``meta`` tensors from
``models.abstract_params`` or ``Model.init_cache`` on the ``meta`` device;
any tensors do), whose paths are the reference's: dict keys, and the field
names of ``KVCache`` / ``SSMState``.  Any axis that does not divide its
dimension is dropped (replicated).  A mesh is anything with axis sizes: a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``, or an object
whose ``shape`` maps axis names to sizes.  ``named_tree`` turns specs into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional

from repro_torch._tree import tree_map, tree_map_with_path

if TYPE_CHECKING:        # the models import constraints, which imports this
    from repro_torch.models.api import ModelConfig

__all__ = ["P", "ShardingRules", "make_rules", "param_specs", "batch_specs",
           "cache_specs", "named_tree", "opt_specs", "NamedSharding",
           "placements_for", "distribute", "is_spec", "mesh_axes"]

DATA = "data"
MODEL = "model"


class P(tuple):
    """A partition spec: ``P("data", None, ("data", "model"))``.  As jax's
    ``PartitionSpec``, an entry of one axis is that axis and an empty entry
    is ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    """``x`` is a ``P`` (the ``is_leaf`` of a walk over a spec tree)."""
    return isinstance(x, P)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: tuple                  # axes for the batch dim
    fsdp: Optional[str]           # axis for FSDP weight sharding
    tensor: Optional[str]         # axis for TP
    expert_parallel: bool         # shard the expert dim over `tensor`
    kv_heads_shard: bool = True   # decode cache: prefer KV-head over seq axis
    # ZeRO-3 layout: shard the non-contracted (output) dim of each weight
    shard_weight_out: bool = False


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def make_rules(cfg: ModelConfig, mesh) -> ShardingRules:
    axes = mesh_axes(mesh)
    has_pod = "pod" in axes
    ep = cfg.moe is not None and cfg.moe.num_experts % axes[MODEL] == 0
    return ShardingRules(
        batch=("pod", DATA) if has_pod else (DATA,),
        fsdp=DATA,
        tensor=MODEL,
        expert_parallel=ep,
    )


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    axes = mesh_axes(mesh)
    if isinstance(axis, tuple):
        return int(math.prod(axes[a] for a in axis))
    return axes[axis]


def _fit(spec: P, shape, mesh) -> P:
    """Drop axes that don't divide their dim; replicate instead."""
    fixed = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        fixed.append(axis if dim % _axis_size(mesh, axis) == 0 else None)
    return P(*fixed)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_COL = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "lm_head")   # (in, out-TP)
_ROW = ("wo", "w_down", "out_proj")                                  # (in-TP, out)
_VEC_TP = ("bq", "bk", "bv", "conv_b", "norm_w")
_HEAD_VEC = ("A_log", "D", "dt_bias")


def _param_rule(name: str, nd: int, r: ShardingRules, in_moe: bool) -> P:
    def lead(base: P) -> P:
        return P(*((None,) * (nd - len(base))), *base)

    if r.shard_weight_out:
        if in_moe and name in ("w_gate", "w_up", "w_down"):
            return lead(P(None, None, r.fsdp))
        if in_moe and name == "router":
            return lead(P(None, None))
        if name == "embed":
            return P(r.fsdp, None)
        if name == "dec_pos":
            return P(None, r.fsdp)
        if name in _COL or name in _ROW:
            return lead(P(None, r.fsdp))
        if name == "conv_w":
            return lead(P(None, r.fsdp))
        if name in _VEC_TP or name in _HEAD_VEC:
            return lead(P(r.fsdp))
        return P(*(None,) * nd)

    if in_moe and name in ("w_gate", "w_up"):
        base = P(r.tensor, r.fsdp, None) if r.expert_parallel else P(None, r.fsdp, r.tensor)
        return lead(base)
    if in_moe and name == "w_down":
        base = P(r.tensor, None, r.fsdp) if r.expert_parallel else P(None, r.tensor, r.fsdp)
        return lead(base)
    if in_moe and name == "router":
        return lead(P(None, None))
    if name == "embed":
        return P(r.tensor, r.fsdp)          # vocab TP, d_model FSDP
    if name == "dec_pos":
        return P(None, r.fsdp)
    if name in _COL:
        return lead(P(r.fsdp, r.tensor))
    if name in _ROW:
        return lead(P(r.tensor, r.fsdp))
    if name == "conv_w":
        return lead(P(None, r.tensor))
    if name in _VEC_TP or name in _HEAD_VEC:
        return lead(P(r.tensor))
    # norms, scalars, everything else: replicated
    return P(*(None,) * nd)


def param_specs(cfg: ModelConfig, mesh, abstract_params,
                rules: Optional[ShardingRules] = None):
    """Spec tree matching a parameter tree (``models.abstract_params(cfg)``
    or the parameters themselves)."""
    r = rules or make_rules(cfg, mesh)

    def assign(path, leaf):
        ps = _path_str(path)
        name = ps.rsplit("/", 1)[-1]
        spec = _param_rule(name, leaf.ndim, r,
                           in_moe="moe/" in ps or ps.startswith("moe"))
        return _fit(spec, tuple(leaf.shape), mesh)

    return tree_map_with_path(assign, abstract_params)


# ---------------------------------------------------------------------------
# batch / cache
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh, abstract_batch,
                rules: Optional[ShardingRules] = None):
    r = rules or make_rules(cfg, mesh)

    def assign(path, leaf):
        name = _path_str(path).rsplit("/", 1)[-1]
        if name == "pos":
            return P()
        if name == "mrope_positions":                      # (nsec, B, S)
            return _fit(P(None, r.batch, None), tuple(leaf.shape), mesh)
        base = P(r.batch, *(None,) * (leaf.ndim - 1))
        return _fit(base, tuple(leaf.shape), mesh)

    return tree_map_with_path(assign, abstract_batch)


def cache_specs(cfg: ModelConfig, mesh, abstract_cache, batch: int,
                rules: Optional[ShardingRules] = None):
    """Decode-state specs assigned by leaf path over the abstract cache.

    KV leaves (named k/v) have layout (L..., B, T, K, hd): batch over the
    batch axes when divisible, the KV heads over the tensor axis when they
    divide it (else the sequence); for batch==1 (long_500k) the sequence
    axis is sharded over ("data", "model") instead.
    """
    r = rules or make_rules(cfg, mesh)
    batch_ok = batch % _axis_size(mesh, r.batch) == 0
    batch_axis = r.batch if batch_ok else None

    def assign(path, leaf):
        name = _path_str(path).rsplit("/", 1)[-1]
        nd = leaf.ndim
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            lead = (None,) * (nd - 4)
            kv_heads = shape[-2]
            if batch_axis is not None:
                if r.kv_heads_shard and kv_heads % _axis_size(mesh, r.tensor) == 0:
                    spec = P(*lead, batch_axis, None, r.tensor, None)
                else:
                    spec = P(*lead, batch_axis, r.tensor, None, None)
            else:
                spec = P(*lead, None, (DATA, MODEL), None, None)
            return _fit(spec, shape, mesh)
        if name == "ssd":                      # (L..., B, H, P, N)
            lead = (None,) * (nd - 4)
            return _fit(P(*lead, batch_axis, r.tensor, None, None), shape, mesh)
        if name == "conv":                     # (L..., B, W-1, conv_dim)
            lead = (None,) * (nd - 3)
            return _fit(P(*lead, batch_axis, None, r.tensor), shape, mesh)
        if name == "enc_out":                  # (B, T_enc, D)
            return _fit(P(batch_axis, None, None), shape, mesh)
        return P(*(None,) * nd)

    return tree_map_with_path(assign, abstract_cache)


def opt_specs(pspecs):
    """Adam (mu, nu) mirror the parameter sharding; step count replicated."""
    return {"mu": pspecs, "nu": pspecs, "count": P()}


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: one DTensor placement per mesh dim."""

    mesh: object
    spec: P
    placements: tuple


def placements_for(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim ``Shard(d)``
    for the tensor dim ``d`` that names it, else ``Replicate()``.  A dim
    split over several axes is sharded on each of their mesh dims, the
    first axis outermost, as jax lays it out; the axes must come in the
    mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named_tree(mesh, spec_tree):
    """``NamedSharding`` per spec of ``spec_tree``."""
    return tree_map(lambda s: NamedSharding(mesh, s, placements_for(mesh, s)),
                    spec_tree, is_leaf=is_spec)


def distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor placed by the congruent
    ``named_tree`` (every rank passes the same whole tensors)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                    tree, shardings)
