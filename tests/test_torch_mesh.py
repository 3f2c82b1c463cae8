"""PyTorch port: the sharded train, prefill and decode steps on real
``torch.distributed`` meshes on the CPU (gloo), and ``ElasticPlan``.

* 1 x 1 mesh in this process: parameters, optimizer state, batch and cache
  are DTensors placed by the production rules, the steps run under the
  ``ActivationPolicy``, and every result is bit-equal to the unsharded
  port's, whose MoE row path there takes the branch DTensor rows take (the
  padded expert buffer and batched matmul; on plain rows it packs the kept
  rows for grouped matmuls, whose sums over rows round differently).  The sharded train step is also held to the dense train tests'
  bars against the reference's *unsharded* step (the reference's sharded
  step fails under the installed jax, ROADMAP.md Queue 3 item 2).
* 2 x 2 mesh over 4 spawned gloo processes, deepseek-7b smoke (tensor
  parallel) and olmoe-1b-7b smoke (expert parallel on 8 experts over 2),
  each as configured and again in 2 microbatches over a batch with masked
  labels (a different count per microbatch), olmoe then with the flat
  dispatch at capacity 1.25 (global capacity, dropped picks; the Switch
  aux loss per microbatch): losses and logits within 1e-5 of the
  unsharded port, first-step
  gradients within 1e-5 of each leaf's largest, decoded tokens equal,
  caches within 1e-5, and parameters after 2 AdamW steps within 1e-5
  wherever the first gradient is clear of float32 noise (> 1e-6).  An
  element whose gradient is noise moves by a different fraction of the
  learning rate in Adam's first step (ROADMAP.md Queue 3 item 14; deepseek
  smoke ``blocks/mlp/w_gate``: -3.7e-8 unsharded, -4.9e-8 on the mesh
  against a leaf scale of 0.064, 1.5e-5 apart after the step at lr 3e-4),
  so those elements are not held.
* ``ElasticPlan.new_mesh`` / ``apply`` on a fake 512-rank group
  ((2, 16, 16) -> (1, 16, 16): local shapes) and on 2 gloo processes
  (pod 2 -> 1: values kept).
* A DTensor handed to a kernel's entry point raises.

A test that starts the default process group in this process ends it in
its fixture; the multi-process cases run this file as their worker.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]

# case -> (arch, config overrides, masked labels)
CASES = {
    "deepseek-7b": ("deepseek-7b", {}, False),
    "olmoe-1b-7b": ("olmoe-1b-7b", {}, False),
    "deepseek-7b-mb2-masked": ("deepseek-7b", {"train_microbatches": 2}, True),
    "olmoe-1b-7b-flat-mb2-masked": (
        "olmoe-1b-7b", {"train_microbatches": 2,
                        "moe": {"dispatch": "flat", "capacity_factor": 1.25}},
        True),
}
LR = 1e-3
B, S, DECODE_STEPS = 4, 16, 4
TOL_LOSS = TOL_LOGITS = TOL_CACHE = TOL_PARAMS = 1e-5
TOL_GRADS = 1e-5          # relative to each leaf's largest gradient
NOISE = 1e-6              # gradients below it are float32 noise here


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(vocab: int, seed: int = 1, masked: bool = False) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:                 # a different count of labels per row
        labels[0, S // 2:] = -1
        labels[B - 1, :3] = -1
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(labels)}


def _config(case: str):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    arch, overrides, masked = CASES[case]
    cfg = get_smoke_config(arch)
    overrides = dict(overrides)
    if "moe" in overrides:
        overrides["moe"] = dataclasses.replace(cfg.moe, **overrides["moe"])
    return dataclasses.replace(cfg, **overrides), masked


def _full(x):
    from repro_torch.parallel.dtensor_ops import is_dtensor

    return x.full_tensor() if is_dtensor(x) else x


def _recording(opt):
    """``opt`` that keeps the gradients of each update in ``.grads``."""
    from repro_torch.optim.adamw import Optimizer

    grads = []

    def update(g, state, params):
        grads.append(g)
        return opt.update(g, state, params)

    rec = Optimizer(init=opt.init, update=update)
    return rec, grads


def _run_both(case: str, mesh, mesh_moe_path: bool = False):
    """The unsharded port and the same steps on ``mesh``: 2 train steps
    (losses, first gradients, parameters, optimizer state), the forward's
    logits and 4 greedy decode steps (tokens, cache) on the initial
    weights; with ``mesh_moe_path`` the unsharded MoE row path takes the
    mesh's branch.  Returns (unsharded, sharded) dicts of plain tensors."""
    from repro_torch._tree import items
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import (ActivationPolicy,
                                                  activation_sharding)

    cfg, masked = _config(case)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = _batch(cfg.vocab_size, masked=masked)
    rules = shd.make_rules(cfg, mesh)
    policy = ActivationPolicy(mesh=mesh, batch_axes=rules.batch,
                              tensor_axis=rules.tensor)
    place = lambda tree, specs: shd.distribute(tree, shd.named_tree(mesh, specs))
    dparams = place(params, shd.param_specs(cfg, mesh, params, rules))
    dbatch = place(batch, shd.batch_specs(cfg, mesh, batch, rules))
    out = []
    for p, b, sharded in ((params, batch, False), (dparams, dbatch, True)):
        ctx = (activation_sharding(policy) if sharded
               else _padded_moe() if mesh_moe_path else _null())
        opt, grads = _recording(adamw(AdamWConfig(learning_rate=LR)))
        step = make_train_step(model, opt)
        res = {"loss": []}
        with ctx:
            state = (p, opt.init(p))
            for _ in range(2):
                *state, metrics = step(*state, b)
                res["loss"].append(float(_full(metrics["total_loss"])))
            with torch.no_grad():
                logits, _ = model.forward(p, {"tokens": b["tokens"]})
            cache = model.init_cache(B, DECODE_STEPS)
            if sharded:
                cache = place(cache, shd.cache_specs(cfg, mesh, cache, B, rules))
            serve = make_serve_step(model)
            tok, toks = b["tokens"][:, :1], []
            for t in range(DECODE_STEPS):
                nxt, cache = serve(p, cache, tok, t)
                toks.append(_full(nxt))
                tok = nxt[:, None]
        res["grads"] = [_full(g) for _, g in items(grads[0])]
        res["state"] = [_full(x) for _, x in items(tuple(state))]
        res["logits"] = _full(logits)
        res["tokens"] = torch.stack(toks)
        res["cache"] = [_full(x) for _, x in items(cache)]
        out.append(res)
    return out


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _padded_moe:
    """``moe_ffn`` on plain rows through its DTensor branch: each
    sequence's padded (E*cap + 1, D) buffer and a batched matmul."""
    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe.is_dtensor
        moe.is_dtensor = lambda x: True
        return self

    def __exit__(self, *exc):
        self.moe.is_dtensor = self.real
        return False


def _params_diff(plain, sharded) -> float:
    """Largest parameter difference after the steps over the elements whose
    first gradient is clear of float32 noise (> NOISE in magnitude)."""
    worst = 0.0
    for g, a, b in zip(plain["grads"], plain["state"], sharded["state"]):
        keep = g.abs() > NOISE
        if keep.any():
            worst = max(worst, float((a - b).abs()[keep].max()))
    return worst


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# 1 x 1 mesh in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo1():
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_steps_on_a_1x1_mesh_are_bit_equal(gloo1, case):
    plain, sharded = _run_both(case, gloo1, mesh_moe_path=True)
    assert plain["loss"] == sharded["loss"]
    for key in ("grads", "state", "cache"):
        assert all(torch.equal(a, b) for a, b in zip(plain[key], sharded[key])), key
    assert torch.equal(plain["logits"], sharded["logits"])
    assert torch.equal(plain["tokens"], sharded["tokens"])


def test_sharded_train_step_matches_reference_unsharded(gloo1):
    """The sharded step on the 1 x 1 mesh against the reference's
    unsharded one: losses within 1e-5 relative; parameters within 1e-5
    where the port's first gradient is clear of float32 noise, the noise
    elements within 2 * steps * lr (under 1 % of each leaf; ROADMAP.md
    Queue 3 item 14: ``blocks/attn/wo``, 1 of 8,192, 1.8e-5 apart)."""
    from torch_port_ref import (assert_params_close, first_step_grads,
                                load_reference)

    from repro_torch._tree import items
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, params_from_reference
    from repro_torch.optim.adamw import AdamWConfig, adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import (ActivationPolicy,
                                                  activation_sharding)

    R = load_reference()
    jax = R.jax
    arch, mesh = "deepseek-7b", gloo1
    jm = R.models.build_model(R.configs.get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=LR))
    jst, jstep = jo.init(jp), jax.jit(R.steps.make_train_step(jm, jo))
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rules = shd.make_rules(cfg, mesh)
    dp = shd.distribute(tp, shd.named_tree(mesh, shd.param_specs(cfg, mesh, tp,
                                                                   rules)))
    to = adamw(AdamWConfig(learning_rate=LR))
    tstep = make_train_step(model, to)
    policy = ActivationPolicy(mesh=mesh, batch_axes=rules.batch,
                              tensor_axis=rules.tensor)
    g1 = first_step_grads(model, tp, _batch(cfg.vocab_size, 1))
    with activation_sharding(policy):
        tst = to.init(dp)
        for step, seed in enumerate((1, 2, 3), 1):
            batch = _batch(cfg.vocab_size, seed)
            jp, jst, jmet = jstep(jp, jst, {k: jax.numpy.asarray(v.numpy())
                                            for k, v in batch.items()})
            db = shd.distribute(batch, shd.named_tree(
                mesh, shd.batch_specs(cfg, mesh, batch, rules)))
            dp, tst, tmet = tstep(dp, tst, db)
            want = float(jmet["total_loss"])
            assert abs(float(_full(tmet["total_loss"])) - want) <= \
                TOL_LOSS * abs(want)
            assert_params_close([(path, _full(t)) for path, t in items(dp)],
                                jax.tree.leaves(jp), g1, atol=TOL_PARAMS,
                                steps=step, lr=LR)


def test_kernel_entry_points_refuse_dtensors(gloo1):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    rep = lambda t: distribute_tensor(t, gloo1, [Replicate(), Replicate()])
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(TypeError, match="plain"):
        kops.flash_attention(rep(q), q, q)
    x = torch.randn(1, 8, 2, 16)
    with pytest.raises(TypeError, match="plain"):
        kops.ssd_scan(rep(x), torch.rand(1, 8, 2), -torch.rand(2),
                      torch.randn(1, 8, 1, 16), torch.randn(1, 8, 1, 16), chunk=8)
    with pytest.raises(TypeError):
        _build.refuse_dtensor("renewal_scan", rep(q))
    _build.refuse_dtensor("renewal_scan", q)          # plain tensors pass


# ---------------------------------------------------------------------------
# ElasticPlan on a fake 512-rank group
# ---------------------------------------------------------------------------

@pytest.fixture
def fake512():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_world(512):
        yield make_production_mesh(multi_pod=True, device_type="cpu")


def test_elastic_plan_shrinks_the_pod_axis(fake512):
    from repro_torch.ft.runtime import ElasticPlan
    from repro_torch.parallel import sharding as shd

    mesh = fake512
    plan = ElasticPlan.shrink(mesh)
    assert plan.old_axes == {"pod": 2, "data": 16, "model": 16}
    assert plan.new_axes == {"pod": 1, "data": 16, "model": 16}
    new = plan.new_mesh(device_type="cpu")
    assert shd.mesh_axes(new) == plan.new_axes
    specs = {"w": shd.P("data", "model"), "b": shd.P(("pod", "data")),
             "n": shd.P()}
    state = {"w": torch.zeros(64, 32), "b": torch.zeros(64), "n": torch.zeros(3)}
    placed = shd.distribute(state, shd.named_tree(mesh, specs))
    assert tuple(placed["b"].to_local().shape) == (2,)
    mesh2, moved = plan.apply(placed, specs, device_type="cpu")
    assert shd.mesh_axes(mesh2) == plan.new_axes
    assert tuple(moved["w"].to_local().shape) == (4, 2)
    assert tuple(moved["b"].to_local().shape) == (4,)
    assert tuple(moved["n"].to_local().shape) == (3,)
    for k in state:
        assert tuple(moved[k].shape) == tuple(state[k].shape)
        assert moved[k].device_mesh is mesh2


# ---------------------------------------------------------------------------
# several processes: this file is their worker
# ---------------------------------------------------------------------------

def _spawn(mode: str, world: int, tmp_path) -> dict:
    port = _free_port()
    out = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), str(port), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return json.loads(out.read_text())


def test_steps_on_a_2x2_mesh_match_the_unsharded_port(tmp_path):
    res = _spawn("steps", 4, tmp_path)
    assert set(res) == set(CASES)
    for case, r in res.items():
        assert r["loss_rel"] <= TOL_LOSS, (case, r)
        assert r["logits"] <= TOL_LOGITS, (case, r)
        assert r["grads"] <= TOL_GRADS, (case, r)
        assert r["params"] <= TOL_PARAMS, (case, r)
        assert r["cache"] <= TOL_CACHE, (case, r)
        assert r["tokens_equal"], (case, r)


def test_elastic_plan_keeps_values_across_two_processes(tmp_path):
    res = _spawn("elastic", 2, tmp_path)
    assert res["equal"] and res["new_axes"] == {"pod": 1, "data": 1, "model": 1}


def _worker(mode: str, rank: int, world: int, port: int, out: str) -> None:
    from repro_torch.launch.mesh import make_host_mesh, mesh_over
    from repro_torch.parallel import sharding as shd

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        if mode == "steps":
            mesh = make_host_mesh(2, 2, device_type="cpu")
            res = {}
            for case in CASES:
                plain, sharded = _run_both(case, mesh)
                res[case] = {
                    "loss_rel": max(abs(a - b) / abs(a) for a, b in
                                    zip(plain["loss"], sharded["loss"])),
                    "logits": _max_diff([plain["logits"]], [sharded["logits"]]),
                    "grads": max(_max_diff([a], [b]) / float(a.abs().max())
                                 for a, b in zip(plain["grads"],
                                                 sharded["grads"])),
                    "params": _params_diff(plain, sharded),
                    "params_all": _max_diff(plain["state"][:len(plain["grads"])],
                                            sharded["state"]),
                    "cache": _max_diff(plain["cache"], sharded["cache"]),
                    "tokens_equal": bool(torch.equal(plain["tokens"],
                                                     sharded["tokens"]))}
        else:
            from repro_torch.ft.runtime import ElasticPlan

            mesh = mesh_over((2, 1, 1), ("pod", "data", "model"), "cpu")
            specs = {"w": shd.P(("pod", "data"), "model"), "c": shd.P()}
            state = {"w": torch.arange(24.0).reshape(6, 4),
                     "c": torch.tensor(7, dtype=torch.int32)}
            placed = shd.distribute(state, shd.named_tree(mesh, specs))
            plan = ElasticPlan.shrink(mesh)
            new_mesh, moved = plan.apply(placed, specs, device_type="cpu")
            equal = True
            if rank == 0:            # the surviving pod holds every shard
                equal = all(torch.equal(moved[k].to_local(), state[k])
                            for k in state)
            res = {"equal": equal, "new_axes": shd.mesh_axes(new_mesh)}
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5])
