"""Multi-pod dry run, the counterpart of ``repro.launch.dryrun``: trace one
step of every (architecture x shape x mesh) cell on the production mesh
with fake inputs, and record what each rank would hold, compute and send.

The reference lowers and compiles each cell for 256 or 512 virtual XLA
host devices and reads XLA's memory analysis and the optimized HLO.  Here
the mesh is a ``DeviceMesh`` over a *fake* process group of that many
ranks (``torch.testing._internal.distributed.fake_pg``: collectives return
at once), and parameters, optimizer state, batch and cache are DTensors
whose local shards are ``meta`` tensors (shapes and dtypes, no storage),
placed by the reference's spec trees (``parallel.sharding``)
under the reference's rule adjustments.  One train, prefill or serve step
(``launch.steps``) runs on them under the activation policy, as rank 0,
and a dispatch mode below DTensor sees every local operation:

  * flops      — per device: the local products' flops
                 (``torch.utils.flop_counter``'s formulas on the local
                 shapes); DTensor's own shape propagation is not counted;
  * collectives — per kind, the ring-model wire bytes
                 (``wire_bytes``, the reference's ``_wire_bytes``) of the
                 result of every collective DTensor issues, and counts;
  * memory     — ``argument_size_in_bytes``: the local shards of the
                 step's tensor arguments (params, optimizer state, batch or
                 cache and tokens; decode's position is a host int, counted
                 as the reference's 4-byte scalar); ``output_size_in_bytes``
                 the outputs' local shards; ``peak_size_in_bytes``: the
                 most local bytes alive at once during the step, arguments
                 included (storages counted once, freed when dropped).  The
                 step is functional, so the peak holds old and new
                 parameters together, where the reference's donation
                 aliases them.

Where the reference reads optimized HLO (``hlo_analysis``: fused HBM
traffic, trip counts) the port has no counterpart: there is no
``bytes_accessed``.  ``--use-flash`` is parsed and ignored, as in the
reference (``run_cell`` never lowers a kernel under the mesh).

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single --out d.json
  python -m repro_torch.launch.dryrun --all --mesh multi     # 2-pod, 512

Records append to ``--out`` (default ``build/dryrun/dryrun_<mesh>.json``),
and cells already there are skipped.  Importing the module sets no
environment and starts no process group; ``main`` and ``fake_world`` do.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import weakref
from typing import Optional

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import (SHAPES, cell_is_skipped, get_config, grid,
                                 input_specs)
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_params, build_model
from repro_torch.optim.adamw import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.constraints import (ActivationPolicy,
                                              activation_sharding)

__all__ = ["run_cell", "main", "fake_world", "wire_bytes", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives DTensor issues -> the reference's kinds
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def wire_bytes(kind: str, result_bytes: float, k: int) -> float:
    """Per-device wire bytes under a ring schedule with group size k.

    all-gather     result is the gathered tensor: (k-1)/k x result
    reduce-scatter result is the shard: input = k x result, wire (k-1) x result
    all-reduce     RS + AG on the (unsharded) payload: 2 (k-1)/k x result
    all-to-all     (k-1)/k x result
    collective-permute  one hop: result
    """
    if k <= 1:
        return 0.0
    f = (k - 1) / k
    if kind == "all-gather":
        return f * result_bytes
    if kind == "reduce-scatter":
        return (k - 1) * result_bytes
    if kind == "all-reduce":
        return 2.0 * f * result_bytes
    if kind == "all-to-all":
        return f * result_bytes
    return result_bytes


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# what one rank does: a dispatch mode below DTensor
# ---------------------------------------------------------------------------

def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class _RankTrace:
    """Counts the local operations of one rank: the ones whose outputs are
    plain ``meta`` tensors (DTensor's shape propagation runs on fake
    tensors of its own, and is skipped)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.flop_registry = flop_registry
        self.flops = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self._live = WeakIdKeyDictionary()
        self.live_bytes = 0
        self.peak_bytes = 0

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def mode(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        trace = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                outs = _tensors(out)
                if outs and all(type(t) is torch.Tensor and t.is_meta
                                for t in outs):
                    trace.count(func, args, kwargs, out, outs)
                return out

        return _Mode()

    def count(self, func, args, kwargs, out, outs) -> None:
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(packet.__name__)
            if kind is not None:
                b = sum(t.numel() * t.element_size() for t in outs)
                self.coll_bytes[kind] += wire_bytes(kind, b, _group_size(args))
                self.coll_counts[kind] += 1
        for t in outs:
            self.track(t)


# ---------------------------------------------------------------------------
# DTensors of meta shards from spec trees
# ---------------------------------------------------------------------------

def _meta_dtensor(global_t: torch.Tensor, sharding):
    """A DTensor of ``global_t``'s shape and dtype whose local shard is a
    ``meta`` tensor of the size the placements give this rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape = tuple(global_t.shape)
    local_shape, _ = compute_local_shape_and_global_offset(
        shape, sharding.mesh, sharding.placements)
    local = torch.empty(local_shape, dtype=global_t.dtype, device="meta")
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _placed(abstract, specs, mesh):
    return tree_map(_meta_dtensor, abstract, shd.named_tree(mesh, specs))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _locals(tree):
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in leaves(tree) if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def _meta_embedding_backward():
    """The embedding's backward on meta shards.  ``layers._segment_sum_rows``
    orders the rows by their token values (a stable sort, then
    ``unique_consecutive``), which meta tensors do not carry; during the
    trace the rows are summed with ``index_add_``, whose output has the
    same shape and dtype."""
    from repro_torch.models import layers

    exact = layers._segment_sum_rows

    def by_index_add(idx, rows, n):
        acc = torch.promote_types(rows.dtype, torch.float32)
        return torch.zeros((n, rows.shape[1]), dtype=acc,
                           device=rows.device).index_add_(0, idx, rows.to(acc))

    layers._segment_sum_rows = by_index_add
    try:
        yield
    finally:
        layers._segment_sum_rows = exact


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             use_flash: bool = False, extra_overrides: Optional[dict] = None):
    """Trace one cell's step on ``mesh`` (over a fake process group of its
    size); return its record."""
    del use_flash                      # parsed and ignored, as the reference
    shape = SHAPES[shape_name]
    axes = shd.mesh_axes(mesh)
    overrides = dict(extra_overrides or {})
    grad_accum = overrides.pop("_grad_accum", "outside")
    seq_shard = overrides.pop("_seq_shard", False)
    moe_flat = overrides.pop("_moe_flat", False)
    kv_seq = overrides.pop("_kv_seq", False)
    zero3 = overrides.pop("_zero3", False)
    decode_tp = overrides.pop("_decode_tp", False)
    cfg = get_config(arch, **overrides)
    if moe_flat and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="flat"))
    rules = shd.make_rules(cfg, mesh)
    if kv_seq:
        rules = dataclasses.replace(rules, kv_heads_shard=False)
    mesh_size = int(math.prod(axes.values()))
    want_zero3 = zero3 or (shape.kind == "train"
                           and cfg.train_parallelism == "zero3")
    if want_zero3 and shape.global_batch % mesh_size == 0:
        # pure ZeRO-3: batch + weights sharded over the flattened mesh, no TP
        names = tuple(axes)
        rules = dataclasses.replace(
            rules, batch=names, fsdp=names, tensor=None, expert_parallel=False)
    elif want_zero3:
        # zero3 requires global_batch % mesh devices == 0; fall back to 2D
        # FSDP+TP with microbatching
        cfg = dataclasses.replace(cfg, train_microbatches=16)
    if shape.kind == "train" and cfg.train_microbatches > 1:
        # each microbatch must still shard over the batch axes
        bax = int(math.prod(axes[a] for a in rules.batch)) or 1
        m_max = max(1, shape.global_batch // bax)
        m = math.gcd(cfg.train_microbatches, m_max)
        if m != cfg.train_microbatches:
            cfg = dataclasses.replace(cfg, train_microbatches=m)
    cache_rules = rules
    if shape.kind == "decode" and not kv_seq:
        if decode_tp or cfg.param_count() * 2 <= 12e9:
            # small models: weights TP-resident, no per-step FSDP gather
            rules = dataclasses.replace(rules, fsdp=None)
            cache_rules = rules
        else:
            # large models: weights stay sharded; decode activations are
            # replicated; the cache keeps its batch sharding
            rules = dataclasses.replace(rules, batch=())
            cache_rules = dataclasses.replace(rules, batch=(
                ("pod", "data") if "pod" in axes else ("data",)))
    # build the model AFTER all config adjustments (the step reads
    # model.config, e.g. train_microbatches)
    model = build_model(cfg, device="meta")
    policy = ActivationPolicy(mesh=mesh, batch_axes=rules.batch or None,
                              tensor_axis=rules.tensor,
                              seq_shard_hidden=seq_shard)

    t0 = time.time()
    abstract = abstract_params(cfg)
    pspecs = shd.param_specs(cfg, mesh, abstract, rules)
    params = _placed(abstract, pspecs, mesh)
    batch_abs = input_specs(cfg, shape)
    trace = _RankTrace()

    if shape.kind in ("train", "prefill"):
        bspecs = shd.batch_specs(cfg, mesh, batch_abs, rules)
        batch = _placed(batch_abs, bspecs, mesh)
        if shape.kind == "train":
            optimizer = adamw()
            with activation_sharding(policy):
                opt_state = optimizer.init(params)
            args = (params, opt_state, batch)
            fn = step_lib.make_train_step(model, optimizer,
                                          grad_accum=grad_accum)
        else:
            args = (params, batch)
            fn = step_lib.make_prefill_step(model)
        extra_bytes = 0
    else:  # decode
        cache_abs = build_model(cfg, device="meta").init_cache(
            shape.global_batch, shape.seq_len)
        cspecs = shd.cache_specs(cfg, mesh, cache_abs, shape.global_batch,
                                 cache_rules)
        cache = _placed(cache_abs, cspecs, mesh)
        tok_axes = rules.batch if rules.batch else None
        if tok_axes is not None and shape.global_batch % int(
                math.prod(axes[a] for a in tok_axes)) != 0:
            tok_axes = None
        tokens = _placed({"tokens": batch_abs["tokens"]},
                         {"tokens": shd.P(tok_axes)}, mesh)["tokens"]
        args = (params, cache, tokens, shape.seq_len - 1)
        fn = step_lib.make_serve_step(model)
        extra_bytes = 4                # the position: the reference's int32

    arg_bytes = _local_bytes(args[:3] if shape.kind == "decode" else args) \
        + extra_bytes
    for t in _locals(args[:3] if shape.kind == "decode" else args):
        trace.track(t)
    with activation_sharding(policy), trace.mode(), _meta_embedding_backward():
        out = fn(*args)
    out_bytes = _local_bytes(out)
    t_trace = time.time() - t0

    full = get_config(arch)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "num_devices": mesh_size,
        "trace_s": round(t_trace, 1),
        "flops": float(trace.flops),
        "collectives": {
            "bytes": {k: float(v) for k, v in trace.coll_bytes.items()},
            "counts": {k: float(v) for k, v in trace.coll_counts.items()},
            "total_bytes": float(sum(trace.coll_bytes.values())),
        },
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "peak_size_in_bytes": int(trace.peak_bytes + extra_bytes),
        },
        "params": full.param_count(),
        "active_params": full.active_param_count(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--use-flash", action="store_true",
                    help="parsed and ignored (no kernel under the mesh)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", action="store_true",
                    help="paper-era baseline: flat MoE dispatch, "
                         "seq-sharded KV caches")
    args = ap.parse_args(argv)

    mesh_name = args.mesh
    cells = grid() if args.all else [(args.arch, args.shape)]
    out_path = pathlib.Path(
        args.out or f"build/dryrun/dryrun_{mesh_name}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    with fake_world(512 if mesh_name == "multi" else 256):
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device_type="cpu")
        for arch, shape_name in cells:
            skip = cell_is_skipped(arch, shape_name)
            if skip:
                print(f"SKIP {arch} x {shape_name}: {skip}")
                continue
            if (arch, shape_name, mesh_name) in done:
                print(f"CACHED {arch} x {shape_name} x {mesh_name}")
                continue
            print(f"=== {arch} x {shape_name} x {mesh_name} ===", flush=True)
            base_overrides = (
                {"_moe_flat": True, "_kv_seq": True,
                 "decode_cache_in_carry": False} if args.baseline else {})
            try:
                rec = run_cell(arch, shape_name, mesh, mesh_name,
                               use_flash=args.use_flash,
                               extra_overrides=base_overrides)
            except Exception as e:  # noqa: BLE001 — report, then re-raise
                print(f"FAILED {arch} x {shape_name}: {type(e).__name__}: {e}",
                      flush=True)
                raise
            print(json.dumps({k: rec[k] for k in ("flops", "trace_s")}),
                  flush=True)
            print("  collectives:", rec["collectives"]["total_bytes"], "B",
                  flush=True)
            print("  memory:", rec["memory"], flush=True)
            results.append(rec)
            out_path.write_text(json.dumps(results, indent=1))
    print(f"wrote {out_path} ({len(results)} records)")


if __name__ == "__main__":
    main()
