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
  * bytes_accessed — per device: the HBM-traffic model of the reference's
                 ``hlo_analysis`` (fusion-boundary bytes), counted op by
                 op with pointwise chains fused (``op_analysis``);
  * collectives — per kind, the ring-model wire bytes
                 (``wire_bytes``, the reference's ``_wire_bytes``) of the
                 result of every collective DTensor issues, and counts;
  * memory     — ``argument_size_in_bytes``: the local shards of the
                 step's tensor arguments (params, optimizer state, batch or
                 cache and tokens; decode's position is a host int, counted
                 as the reference's 4-byte scalar); ``output_size_in_bytes``
                 the outputs' local shards; ``peak_size_in_bytes``: the
                 most local bytes alive at once during the step, arguments
                 included (storages counted once, freed when dropped);
                 ``temp_size_in_bytes``: the most local bytes alive at once
                 that belong to neither the arguments nor the outputs,
                 exact for the order in which the ops ran (not a bound on
                 a schedule a compiler might choose).  The step is
                 functional, so the peak holds old and new parameters
                 together, where the reference's donation aliases them.

The walker is ``op_analysis.OpTrace``, the counterpart of the reference's
``hlo_analysis``.  The record's keys follow the reference's: ``trace_s``
stands where it has ``lower_s`` and ``compile_s``, and its ``xla_flops``
and ``xla_bytes_accessed`` (XLA's own numbers, which count a loop body
once) have no counterpart and are not written.  ``--use-flash`` is parsed
and ignored, as in the reference (``run_cell`` never lowers a kernel
under the mesh).

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
from typing import Optional

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import (SHAPES, cell_is_skipped, get_config, grid,
                                 input_specs)
from repro_torch.launch import steps as step_lib
from repro_torch.launch.op_analysis import (COLLECTIVES, OpTrace,
                                            wire_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_params, build_model
from repro_torch.optim.adamw import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.constraints import (ActivationPolicy,
                                              activation_sharding)

__all__ = ["run_cell", "main", "fake_world", "wire_bytes", "COLLECTIVES"]

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
    trace = OpTrace("meta")

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
    trace.arguments(args[:3] if shape.kind == "decode" else args)
    with activation_sharding(policy), trace, _meta_embedding_backward():
        out = fn(*args)
    trace.outputs(out)
    out_bytes = _local_bytes(out)
    t_trace = time.time() - t0
    cost = trace.cost

    full = get_config(arch)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "num_devices": mesh_size,
        "trace_s": round(t_trace, 1),
        "flops": float(cost.flops),
        "bytes_accessed": float(cost.bytes),
        "collectives": {
            "bytes": {k: float(v) for k, v in cost.collective_bytes.items()},
            "counts": {k: float(v) for k, v in cost.collective_counts.items()},
            "total_bytes": float(cost.total_collective_bytes),
        },
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "peak_size_in_bytes": int(trace.peak_bytes + extra_bytes),
            "temp_size_in_bytes": int(trace.temp_bytes),
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
            print(json.dumps({k: rec[k] for k in
                              ("flops", "bytes_accessed", "trace_s")}),
                  flush=True)
            print("  collectives:", rec["collectives"]["total_bytes"], "B",
                  flush=True)
            print("  memory:", rec["memory"], flush=True)
            results.append(rec)
            out_path.write_text(json.dumps(results, indent=1))
    print(f"wrote {out_path} ({len(results)} records)")


if __name__ == "__main__":
    main()
