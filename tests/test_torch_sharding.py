"""PyTorch port: the sharding rules, activation constraints and the
registry's dry-run inputs against the JAX reference.

Spec trees are pure data on both sides, so they compare leaf for leaf,
keyed by path, with the reference's ``PartitionSpec`` trees: parameters
for all ten archs on the reference's shape-only production meshes
(``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``), batches
for every ``input_specs`` cell of the grid, decode caches at ``decode_32k``
(batch 128) and ``long_500k`` (batch 1), and the rule variants the dry run
derives (``shard_weight_out``, ``kv_heads_shard=False``, ZeRO-3, decode's
``fsdp=None`` and ``batch=()``).  The reference's own
``tests/test_sharding.py`` assertions are ported.  ``named_tree``'s
placements are checked on a 16 x 16 ``DeviceMesh`` over a fake process
group: each DTensor's local shape is the spec's arithmetic.
"""
import dataclasses
import math

import pytest
import torch

from torch_port_ref import load_reference

from repro_torch._tree import items
from repro_torch.configs import (ARCHS, SHAPES, get_config, grid,
                                 input_specs)
from repro_torch.models import abstract_params, build_model
from repro_torch.parallel import constraints as tcons
from repro_torch.parallel import sharding as shd


class _FakeMesh:
    """Shape-only stand-in (the reference test's)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape.keys())


PROD = _FakeMesh({"data": 16, "model": 16})
PROD_MP = _FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = pytest.mark.parametrize("mesh", [PROD, PROD_MP],
                                 ids=["single", "multi"])


@pytest.fixture(scope="module")
def R():
    R = load_reference()
    from repro.parallel import constraints, sharding
    R.sharding, R.constraints = sharding, constraints
    return R


def _ref_flat(R, tree):
    jax = R.jax
    P = jax.sharding.PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {R.sharding._path_str(p): tuple(s) for p, s in flat}


def _port_flat(tree):
    return {"/".join(map(str, p)): tuple(s)
            for p, s in items(tree, is_leaf=shd.is_spec)}


def _ref_abstract(R, arch, **over):
    jax = R.jax
    model = R.models.build_model(R.configs.get_config(arch, **over))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _assert_same(R, ref_tree, port_tree):
    want, got = _ref_flat(R, ref_tree), _port_flat(port_tree)
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, diff


# ---------------------------------------------------------------------------
# spec parity
# ---------------------------------------------------------------------------

@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(R, arch, mesh):
    _, ab = _ref_abstract(R, arch)
    jcfg, tcfg = R.configs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(shd.make_rules(tcfg, mesh)) == \
        dataclasses.asdict(R.sharding.make_rules(jcfg, mesh))
    _assert_same(R, R.sharding.param_specs(jcfg, mesh, ab),
                 shd.param_specs(tcfg, mesh, abstract_params(tcfg)))


@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(R, arch, mesh):
    jax = R.jax
    model, _ = _ref_abstract(R, arch)
    jcfg, tcfg = R.configs.get_config(arch), get_config(arch)
    meta = build_model(tcfg, device="meta")
    for batch, seq in ((128, 32_768), (1, 524_288)):
        ref = jax.eval_shape(lambda: model.init_cache(batch, seq))
        _assert_same(R, R.sharding.cache_specs(jcfg, mesh, ref, batch),
                     shd.cache_specs(tcfg, mesh, meta.init_cache(batch, seq),
                                     batch))


@MESHES
@pytest.mark.parametrize("arch,shape", grid())
def test_grid_inputs_and_batch_specs_match_reference(R, arch, shape, mesh):
    jcfg, tcfg = R.configs.get_config(arch), get_config(arch)
    ref = R.configs.input_specs(jcfg, R.configs.SHAPES[shape])
    got = input_specs(tcfg, SHAPES[shape])
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k
    _assert_same(R, R.sharding.batch_specs(jcfg, mesh, ref),
                 shd.batch_specs(tcfg, mesh, got))


def test_grid_matches_reference(R):
    assert grid() == R.configs.grid()
    assert len(grid()) == 33          # 40 total - 7 skipped long_500k


def _variants(rules, mesh):
    """The rule sets the dry run derives (``dryrun.run_cell``)."""
    names = tuple(mesh.shape)
    yield "shard_weight_out", dataclasses.replace(rules, shard_weight_out=True)
    yield "kv_seq", dataclasses.replace(rules, kv_heads_shard=False)
    yield "zero3", dataclasses.replace(rules, batch=names, fsdp=names,
                                       tensor=None, expert_parallel=False)
    yield "decode_tp", dataclasses.replace(rules, fsdp=None)
    yield "decode_big", dataclasses.replace(rules, batch=())


@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_variants_match_reference(R, arch, mesh):
    jax = R.jax
    model, ab = _ref_abstract(R, arch)
    jcfg, tcfg = R.configs.get_config(arch), get_config(arch)
    meta = build_model(tcfg, device="meta")
    jrules = R.sharding.make_rules(jcfg, mesh)
    trules = shd.make_rules(tcfg, mesh)
    ref_cache = jax.eval_shape(lambda: model.init_cache(128, 4096))
    cache = meta.init_cache(128, 4096)
    shape = SHAPES["train_4k"]
    for (name, jr), (_, tr) in zip(_variants(jrules, mesh),
                                   _variants(trules, mesh)):
        _assert_same(R, R.sharding.param_specs(jcfg, mesh, ab, jr),
                     shd.param_specs(tcfg, mesh, abstract_params(tcfg), tr))
        _assert_same(R, R.sharding.cache_specs(jcfg, mesh, ref_cache, 128, jr),
                     shd.cache_specs(tcfg, mesh, cache, 128, tr))
        _assert_same(R, R.sharding.batch_specs(
            jcfg, mesh, R.configs.input_specs(jcfg, R.configs.SHAPES[
                "train_4k"]), jr),
            shd.batch_specs(tcfg, mesh, input_specs(tcfg, shape), tr))
    ref_opt = R.sharding.opt_specs(R.sharding.param_specs(jcfg, mesh, ab))
    _assert_same(R, ref_opt, shd.opt_specs(
        shd.param_specs(tcfg, mesh, abstract_params(tcfg))))


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding.py, ported
# ---------------------------------------------------------------------------

@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide(arch, mesh):
    cfg = get_config(arch)
    abstract = abstract_params(cfg)
    specs = shd.param_specs(cfg, mesh, abstract)
    flat_p = list(items(abstract))
    flat_s = list(items(specs, is_leaf=shd.is_spec))
    assert [p for p, _ in flat_p] == [p for p, _ in flat_s]
    for (_, leaf), (_, spec) in zip(flat_p, flat_s):
        assert len(spec) <= leaf.ndim
        for dim, axes in zip(leaf.shape, spec):
            size = 1
            if axes is not None:
                for a in (axes if isinstance(axes, tuple) else (axes,)):
                    size *= mesh.shape[a]
            assert dim % size == 0, f"{arch}: {tuple(leaf.shape)} vs {spec}"


@pytest.mark.parametrize("arch", ["qwen2-72b", "mixtral-8x22b", "olmoe-1b-7b"])
def test_tp_is_used_on_big_weights(arch):
    cfg = get_config(arch)
    abstract = abstract_params(cfg)
    specs = dict(items(shd.param_specs(cfg, PROD, abstract),
                       is_leaf=shd.is_spec))
    path, leaf = max(items(abstract),
                     key=lambda t: math.prod(t[1].shape))
    used = [a for e in specs[path] if e
            for a in (e if isinstance(e, tuple) else (e,))]
    assert "model" in used and "data" in used, (tuple(leaf.shape), specs[path])


def test_moe_ep_vs_tp_rule():
    assert shd.make_rules(get_config("olmoe-1b-7b"), PROD).expert_parallel
    assert not shd.make_rules(get_config("mixtral-8x22b"), PROD).expert_parallel


def test_cache_specs_long_context():
    cfg = get_config("zamba2-7b")
    cache = build_model(cfg, device="meta").init_cache(1, 524_288)
    specs = shd.cache_specs(cfg, PROD, cache, batch=1)
    assert ("data", "model") in tuple(specs["shared_kv"].k)


def test_vocab_not_divisible_falls_back():
    cfg = get_config("whisper-medium", pad_vocab_multiple=1)
    specs = shd.param_specs(cfg, PROD, abstract_params(cfg))
    assert specs["embed"][0] is None


def test_partition_spec_normalises_as_jax(R):
    P = R.jax.sharding.PartitionSpec
    for entries in ((("data",), None), ((), None), (("pod", "data"), "model"),
                    ()):
        assert tuple(shd.P(*entries)) == tuple(P(*entries))


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

KINDS = ("hidden", "logits", "batch", "experts", "other")
SHAPES_ACT = ((256, 4096, 8192), (128, 1, 1024), (1, 4096, 51865),
              (64, 8, 4), (8, 24, 100), (12, 4096, 8))


@MESHES
@pytest.mark.parametrize("seq_shard", [False, True])
def test_spec_for_matches_reference(R, mesh, seq_shard):
    batches = (("data",), ("pod", "data"), None, ())
    for batch in batches:
        if batch and not set(batch) <= set(mesh.shape):
            continue
        for tensor in ("model", None):
            kw = dict(batch_axes=batch, tensor_axis=tensor,
                      seq_shard_hidden=seq_shard)
            ref = R.constraints.ActivationPolicy(mesh=mesh, **kw)
            got = tcons.ActivationPolicy(mesh=mesh, **kw)
            for kind in KINDS:
                for shape in SHAPES_ACT:
                    want = ref.spec_for(kind, shape)
                    have = got.spec_for(kind, shape)
                    assert (have is None) == (want is None), (kind, shape, kw)
                    if want is not None:
                        assert tuple(have) == tuple(want), (kind, shape, kw)


def test_constrain_without_policy_or_dtensor_is_identity():
    x = torch.randn(4, 8, 16)
    assert tcons.constrain(x, "hidden") is x
    with tcons.activation_sharding(tcons.ActivationPolicy(
            mesh=PROD, batch_axes=("data",))):
        assert tcons.constrain(x, "hidden") is x
        assert tcons.constrain(x, "logits") is x


# ---------------------------------------------------------------------------
# placements on a DeviceMesh (fake process group of 256 ranks)
# ---------------------------------------------------------------------------

@pytest.fixture
def fake256():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_world(256):
        yield make_production_mesh(device_type="cpu")


def _local_shape(shape, spec, axes):
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                out[d] //= axes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", ["qwen2-72b", "olmoe-1b-7b", "zamba2-7b",
                                  "whisper-medium"])
def test_named_tree_local_shapes(fake256, arch):
    from torch.distributed.tensor import DTensor

    mesh = fake256
    cfg = get_config(arch, num_layers=2) if arch != "zamba2-7b" \
        else get_config(arch, num_layers=7)
    abstract = abstract_params(cfg)
    specs = shd.param_specs(cfg, mesh, abstract)
    shardings = shd.named_tree(mesh, specs)
    axes = shd.mesh_axes(mesh)
    assert axes == {"data": 16, "model": 16}
    for (path, leaf), (_, s) in zip(items(abstract), items(shardings)):
        local = torch.empty(_local_shape(leaf.shape, s.spec, axes),
                            dtype=leaf.dtype, device="meta")
        dt = DTensor.from_local(local, mesh, s.placements, run_check=False,
                                shape=leaf.shape, stride=leaf.stride())
        assert tuple(dt.shape) == tuple(leaf.shape), path
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        want, _ = compute_local_shape_and_global_offset(
            tuple(leaf.shape), mesh, s.placements)
        assert tuple(want) == _local_shape(leaf.shape, s.spec, axes), path


def test_placements_split_over_two_axes_are_data_major(fake256):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake256
    assert shd.placements_for(mesh, shd.P(None, ("data", "model"))) == \
        (Shard(1), Shard(1))
    assert shd.placements_for(mesh, shd.P("model", "data")) == \
        (Shard(1), Shard(0))
    assert shd.placements_for(mesh, shd.P()) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        shd.placements_for(mesh, shd.P(("model", "data")))
