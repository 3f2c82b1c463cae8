"""PyTorch port: the dry run (``repro_torch.launch.dryrun``) and the
production lowering of both CLIs.

The dry run traces one step of a cell on a 16 x 16 ``DeviceMesh`` over a
fake process group of 256 ranks, in a subprocess (the group is process
global).  ``mamba2-370m x decode_32k`` runs in the default tier: 256
devices, flops > 0, and per-device argument bytes equal to the sum over
the *reference's* spec trees (parameters and cache under the dry run's
decode rules, the token batch, the 4-byte position).  The slow tier holds
``train_4k`` to the reference test's bars (``tests/test_dryrun.py``).  The
ring model of the collective bytes is the reference's
``hlo_analysis._wire_bytes``, case by case.  Each record has the memory
term, as the reference's does: ``bytes_accessed > 0`` and
``temp_size_in_bytes > 0`` (the reference test's bar); on ``train_4k``
``bytes_accessed`` is at least what AdamW's update must write (the new
parameters and both moments: the argument bytes less the batch's, from the
reference's batch specs).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from torch_port_ref import load_reference

from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run_cell(arch: str, shape: str, tmp_path, extra=()):
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    recs = json.loads(out.read_text())
    assert len(recs) == 1
    return recs[0]


@pytest.mark.parametrize("k", [1, 2, 16, 256])
def test_wire_bytes_match_reference(k):
    from repro.launch import hlo_analysis

    for kind in dryrun.COLLECTIVES:
        for b in (0.0, 1.0, 4096.0, 3.5e9):
            assert dryrun.wire_bytes(kind, b, k) == \
                hlo_analysis._wire_bytes(kind, b, k), (kind, b, k)


def _local_bytes(specs, leaves, mesh_shape) -> int:
    total = 0
    for spec, leaf in zip(specs, leaves):
        n = 1
        for d, dim in enumerate(leaf.shape):
            entry = tuple(spec)[d] if d < len(tuple(spec)) else None
            size = 1
            for a in (entry if isinstance(entry, tuple) else
                      (entry,) if entry else ()):
                size *= mesh_shape[a]
            n *= dim // size
        total += n * leaf.dtype.itemsize
    return total


def _reference_decode_argument_bytes(arch: str, shape_name: str) -> int:
    """Per-device bytes of the decode step's arguments, from the
    reference's rules, spec trees and shapes (its dry run's decode
    branch)."""
    R = load_reference()
    from repro.parallel import sharding as rshd

    jax = R.jax
    P = jax.sharding.PartitionSpec

    class Mesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    cfg = R.configs.get_config(arch)
    shape = R.configs.SHAPES[shape_name]
    rules = rshd.make_rules(cfg, Mesh)
    assert cfg.param_count() * 2 <= 12e9        # the small-model branch
    rules = dataclasses.replace(rules, fsdp=None)
    model = R.models.build_model(cfg)
    ab = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    leaves = lambda t: jax.tree.leaves(t, is_leaf=lambda x: isinstance(x, P))
    total = _local_bytes(leaves(rshd.param_specs(cfg, Mesh, ab, rules)),
                         jax.tree.leaves(ab), Mesh.shape)
    total += _local_bytes(
        leaves(rshd.cache_specs(cfg, Mesh, cache, shape.global_batch, rules)),
        jax.tree.leaves(cache), Mesh.shape)
    tok = jax.ShapeDtypeStruct((shape.global_batch, 1), jax.numpy.int32)
    total += _local_bytes([P(rules.batch)], [tok], Mesh.shape)
    return total + 4                             # the int32 position


def _reference_train_batch_bytes(arch: str, shape_name: str) -> int:
    """Per-device bytes of the train step's batch, from the reference's
    rules and batch specs (its dry run's train branch, without ZeRO-3)."""
    R = load_reference()
    from repro.parallel import sharding as rshd

    jax = R.jax
    P = jax.sharding.PartitionSpec

    class Mesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    cfg = R.configs.get_config(arch)
    assert cfg.train_parallelism != "zero3"
    batch = R.configs.input_specs(cfg, R.configs.SHAPES[shape_name])
    specs = rshd.batch_specs(cfg, Mesh, batch, rshd.make_rules(cfg, Mesh))
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return _local_bytes(leaves, jax.tree.leaves(batch), Mesh.shape)


def test_dryrun_decode_cell(tmp_path):
    rec = _run_cell("mamba2-370m", "decode_32k", tmp_path)
    assert rec["num_devices"] == 256
    assert rec["flops"] > 0
    assert rec["bytes_accessed"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == \
        _reference_decode_argument_bytes("mamba2-370m", "decode_32k")
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
    assert set(rec["collectives"]) == {"bytes", "counts", "total_bytes"}
    for key in ("bytes", "counts"):
        assert set(rec["collectives"][key]) == set(dryrun.COLLECTIVES)
    assert rec["collectives"]["total_bytes"] == \
        sum(rec["collectives"]["bytes"].values())
    R = load_reference()
    cfg = R.configs.get_config("mamba2-370m")
    assert rec["params"] == cfg.param_count()
    assert rec["active_params"] == cfg.active_param_count()


@pytest.mark.slow
def test_dryrun_train_cell_collectives(tmp_path):
    rec = _run_cell("mamba2-370m", "train_4k", tmp_path)
    c = rec["collectives"]
    # FSDP weight gathers + gradient reductions must appear
    assert c["counts"]["all-gather"] > 48        # > one per layer
    assert c["total_bytes"] > 1e9
    # per-device flops within sane multiples of 6ND (remat <= ~2x)
    model = 6 * rec["active_params"] * 4096 * 256 / rec["num_devices"]
    assert 0.8 * model < rec["flops"] < 3.0 * model
    # the memory term: at least AdamW's writes of parameters and moments
    mem = rec["memory"]
    adamw_writes = mem["argument_size_in_bytes"] - \
        _reference_train_batch_bytes("mamba2-370m", "train_4k")
    assert rec["bytes_accessed"] >= adamw_writes > 0
    assert mem["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# --production-lower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,argv,want", [
    ("serve", ["--arch", "qwen2-72b", "--production-lower", "--shape",
               "decode_32k"], ["--arch", "qwen2-72b", "--shape", "decode_32k"]),
    ("serve", ["--arch", "mamba2-370m", "--production-lower"],
     ["--arch", "mamba2-370m", "--shape", "decode_32k"]),
    ("train", ["--arch", "deepseek-7b", "--production-lower"],
     ["--arch", "deepseek-7b", "--shape", "train_4k"]),
    ("train", ["--arch", "olmoe-1b-7b", "--production-lower", "--shape",
               "prefill_32k"], ["--arch", "olmoe-1b-7b", "--shape",
                                "prefill_32k"]),
])
def test_production_lower_spawns_the_dry_run(monkeypatch, cli, argv, want):
    from repro_torch.launch import serve, train

    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 3)
    with pytest.raises(SystemExit) as exc:
        (serve if cli == "serve" else train).main(argv)
    assert exc.value.code == 3
    assert calls == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                      *want]]


def test_dryrun_sets_no_environment_at_import():
    code = ("import os; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh; "
            "import torch.distributed as dist; "
            "assert dict(os.environ) == before; "
            "assert not dist.is_initialized(); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
