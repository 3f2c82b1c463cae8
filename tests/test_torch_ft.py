"""PyTorch port: the FT runtime against the JAX reference, case by case as
``tests/test_ft.py`` (not its gradient-compression cases, which wait for
``parallel/compression.py``): the pod checkpoint manager (roundtrip, GC,
staggered phases equal to the reference's offsets, the shape check,
bfloat16 leaves bit-exact, checkpoints crossing between the two packages),
failure -> localized rollback -> deterministic re-execution, the energy
manager's decisions and the event dicts against the reference's on the
same schedule, and the ``launch.train`` CLI.

The model is the deepseek-7b smoke config with the reference's
``init(PRNGKey(0))`` weights carried over, trained on the CPU.  Bars: the
port's recovered state is bit-equal to its failure-free run (the
reference holds itself to 1e-5); Algorithm-1 floats (float32 on both
sides) within 1e-6 relative of the reference's, discrete decisions equal;
losses against the reference's within 1e-5 relative.
"""
import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch import configs as tconfigs
from repro_torch._tree import leaves, tree_map
from repro_torch.checkpoint.manager import CheckpointConfig, PodCheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft import runtime as T
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model, params_from_reference
from repro_torch.optim.adamw import AdamWConfig, adamw

ARCH = "deepseek-7b"
TOL_FLOAT = 1e-6
TOL_LOSS = 1e-5


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.fixture(scope="module")
def setup(R):
    """(reference step, reference state, port step, port state, both
    pipelines): the test_ft.py small setup on both sides."""
    jax = R.jax
    jcfg = R.configs.get_smoke_config(ARCH)
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=1e-3))
    jstep = jax.jit(R.steps.make_train_step(jm, jopt))
    tcfg = tconfigs.get_smoke_config(ARCH)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    topt = adamw(AdamWConfig(learning_rate=1e-3))
    tstep = tsteps.make_train_step(tm, topt)
    jpipe = R.pipeline.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16,
                                   global_batch=4)
    tpipe = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16,
                        global_batch=4, device="cpu")
    return dict(jstep=jstep, jstate=(jp, jopt.init(jp)), jpipe=jpipe,
                tstep=tstep, tstate=(tp, topt.init(tp)), tpipe=tpipe)


def _trainer(setup, root, *, schedule=None, side="t", **kw):
    if side == "t":
        mod, ck = T, CheckpointConfig
    else:
        ref = load_reference()
        mod, ck = ref.ft_runtime, ref.checkpoint.CheckpointConfig
    ckpt_kw = dict(interval_steps=4, async_save=False)
    ckpt_kw.update(kw.pop("ckpt", {}))
    cluster = kw.pop("cluster", dict(n_pods=3, step_time_s=10.0))
    extra = {"device": "cpu"} if side == "t" else {}
    return mod.FTTrainer(
        step_fn=setup[side + "step"], pipeline=setup[side + "pipe"],
        state=setup[side + "state"], cluster=mod.ClusterSpec(**cluster),
        ckpt_cfg=ck(root=str(root), **ckpt_kw),
        injector=mod.FailureInjector(dict(schedule or {})), **extra, **kw)


def _assert_decisions_close(got: dict, want: dict):
    assert set(got) == set(want)
    for pod in want:
        g, w = got[pod], want[pod]
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= TOL_FLOAT * max(abs(w[k]), 1.0), (pod, k)
            else:
                assert g[k] == w[k], (pod, k)


def _assert_events_close(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("kind", "step", "pod", "rollback_to", "reexec_steps",
                  "gap_s", "policy"):
            assert g[k] == w[k], k
        for k in ("saving_j", "saving_pct"):
            assert abs(g[k] - w[k]) <= TOL_FLOAT * abs(w[k]), k
        _assert_decisions_close(g["decisions"], w["decisions"])


def _state_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, setup):
    state = setup["tstate"]
    mgr = PodCheckpointManager(CheckpointConfig(root=str(tmp_path)), pod_id=0)
    mgr.save(7, state)
    step, restored = mgr.restore(state)
    assert step == 7
    assert isinstance(restored, tuple) and set(restored[1]) == {"mu", "nu", "count"}
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "pod_0" / "step_7" / "meta.json").read_text())
    assert "0/blocks/attn/wq" in meta["leaves"] and "1/count" in meta["leaves"]
    assert meta["dtypes"]["1/count"] == "int32"


def test_checkpoint_gc_and_latest(tmp_path, setup):
    mgr = PodCheckpointManager(
        CheckpointConfig(root=str(tmp_path), keep=2, async_save=False), pod_id=1)
    for s in (5, 10, 15):
        mgr.save(s, setup["tstate"])
    assert mgr.latest_step() == 15
    steps = sorted(int(p.name.split("_")[1]) for p in mgr.dir.glob("step_*"))
    assert steps == [10, 15]
    assert [r["step"] for r in mgr.io_log] == [5, 10, 15]


@pytest.mark.parametrize("cfg", [dict(interval_steps=100, jitter_frac=0.5),
                                 dict(interval_steps=7, jitter_frac=0.9),
                                 dict(interval_steps=6, phase_offset_steps=1)])
def test_uncoordinated_cadences_match_reference(R, tmp_path, cfg):
    mine = [PodCheckpointManager(CheckpointConfig(root=str(tmp_path / "t"), **cfg), p)
            for p in range(8)]
    ref = [R.checkpoint.PodCheckpointManager(
        R.checkpoint.CheckpointConfig(root=str(tmp_path / "j"), **cfg), p)
        for p in range(8)]
    assert [m._offset for m in mine] == [m._offset for m in ref]
    assert [m._phase for m in mine] == [m._phase for m in ref]
    if "jitter_frac" in cfg and cfg["interval_steps"] == 100:
        assert len({m._offset for m in mine}) > 1, "phases must be staggered"
    for m, r in zip(mine, ref):
        assert [m.due(s) for s in range(30)] == [r.due(s) for s in range(30)]
        assert [m.age_steps(s) for s in range(30)] == [r.age_steps(s) for s in range(30)]
        m.set_interval_steps(3)
        r.set_interval_steps(3)
        assert m._offset == r._offset and m.cfg.interval_steps == 3
    with pytest.raises(ValueError):
        mine[0].set_interval_steps(0)


def test_restore_shape_mismatch_raises(tmp_path, setup):
    state = setup["tstate"]
    mgr = PodCheckpointManager(
        CheckpointConfig(root=str(tmp_path), async_save=False), pod_id=0)
    mgr.save(1, state)
    bad = tree_map(lambda x: torch.zeros(x.shape + (2,), dtype=x.dtype), state)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)


def test_bf16_leaves_restore_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn((5, 7), generator=gen).to(torch.bfloat16),
              "b": torch.tensor([1e-40, -0.0, float("inf"), 3.0]).to(torch.bfloat16)}
    state = (params, adamw().init(params))
    mgr = PodCheckpointManager(CheckpointConfig(root=str(tmp_path)), pod_id=2)
    mgr.save(3, state)
    _, restored = mgr.restore(state)
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    with np.load(tmp_path / "pod_2" / "step_3" / "arrays.npz") as z:
        assert z["0/w"].dtype == np.uint16
    meta = json.loads((tmp_path / "pod_2" / "step_3" / "meta.json").read_text())
    assert meta["dtypes"]["0/w"] == "bfloat16" and meta["dtypes"]["1/mu/w"] == "float32"


def test_checkpoints_cross_between_reference_and_port(R, tmp_path, setup):
    """A float32 checkpoint the reference wrote restores in the port
    unchanged (same keys), and one the port wrote restores in the
    reference."""
    jax = R.jax
    jstate, tstate = setup["jstate"], setup["tstate"]
    R.checkpoint.PodCheckpointManager(
        R.checkpoint.CheckpointConfig(root=str(tmp_path / "j"), async_save=False),
        0).save(4, jstate)
    step, got = PodCheckpointManager(
        CheckpointConfig(root=str(tmp_path / "j")), 0).restore(tstate)
    assert step == 4
    for a, b in zip(leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    PodCheckpointManager(CheckpointConfig(root=str(tmp_path / "t"),
                                          async_save=False), 0).save(6, tstate)
    step, back = R.checkpoint.PodCheckpointManager(
        R.checkpoint.CheckpointConfig(root=str(tmp_path / "t")), 0).restore(jstate)
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_async_save_snapshots_before_the_writer_starts(tmp_path, monkeypatch):
    """The writer gets host copies taken at ``save``: changing the state
    afterwards (or freeing it) does not reach the checkpoint; a failed
    write surfaces at the next ``wait``."""
    state = ({"w": torch.arange(6.0)}, {"count": torch.zeros((), dtype=torch.int32)})
    mgr = PodCheckpointManager(CheckpointConfig(root=str(tmp_path)), pod_id=0)
    mgr.save(1, state)
    state[0]["w"].add_(100.0)
    _, restored = mgr.restore(state)
    assert torch.equal(restored[0]["w"], torch.arange(6.0))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(2, state)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert mgr.latest_step() == 1


# ---------------------------------------------------------------------------
# deterministic replay + trainer
# ---------------------------------------------------------------------------

def test_pipeline_is_replayable():
    pipe = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2, seed=3,
                       device="cpu")
    a, b, c = pipe.batch_at(42), pipe.batch_at(42), pipe.batch_at(43)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_failure_recovery_is_deterministic(R, tmp_path, setup):
    """A run with a failure (rollback to the failed pod's checkpoint +
    re-execution) ends in the failure-free run's state bit for bit; its
    events equal the reference's on the same schedule, and its losses the
    reference's."""
    ck = dict(interval_steps=4, jitter_frac=0.9)
    ref = _trainer(setup, tmp_path / "ref")
    ref.run(12)
    failed = _trainer(setup, tmp_path / "a", schedule={9: 2}, ckpt=ck)
    failed.run(12)
    assert len(failed.events) == 1
    ev = failed.events[0]
    assert ev["pod"] == 2 and ev["reexec_steps"] >= 1
    assert _state_equal(failed.state, ref.state), "recovery broke determinism"
    assert [h["loss"] for h in failed.history] == [h["loss"] for h in ref.history]
    j = _trainer(setup, tmp_path / "j", schedule={9: 2}, ckpt=ck, side="j")
    j.run(12)
    _assert_events_close(failed.events, j.events)
    for h, hj in zip(failed.history, j.history):
        assert h["step"] == hj["step"]
        assert abs(h["loss"] - hj["loss"]) <= TOL_LOSS * hj["loss"]
    assert failed.sim_balanced_s == j.sim_balanced_s
    assert abs(failed.energy.ledger_total_j() - j.energy.ledger_total_j()) \
        <= TOL_FLOAT * j.energy.ledger_total_j()


def test_move_ahead_decision_tracks_cadence(R):
    kw = dict(step=10, failed_pod=0, reexec_steps=5,
              ckpt_ages_s=np.full(4, 1000.0), ckpt_duration_s=120.0,
              progress_frac=np.full(4, 0.5))
    for mod, extra in ((T, {"device": "cpu"}), (R.ft_runtime, {})):
        slow = mod.EnergyManager(mod.ClusterSpec(n_pods=4, step_time_s=10.0), **extra)
        fast = mod.EnergyManager(mod.ClusterSpec(n_pods=4, step_time_s=10.0,
                                                 ckpt_interval_s=1800.0), **extra)
        assert not any(d["move_ahead_ckpt"]
                       for d in slow.on_failure(**kw).decisions.values())
        assert all(d["move_ahead_ckpt"]
                   for d in fast.on_failure(**kw).decisions.values())


def test_trainer_syncs_predictor_interval_to_cadence(tmp_path, setup):
    tr = _trainer(setup, tmp_path, ckpt=dict(async_save=True))
    assert tr.cluster.ckpt_interval_s == 40.0
    assert tr.energy.cluster.ckpt_interval_s == 40.0
    assert tr.energy.device == torch.device("cpu")


def test_ledger_replay_is_bit_for_bit(R, tmp_path, setup):
    """Survivor progress comes from a keyed stream (a function of seed and
    step), so replaying the same schedule reproduces the ledger exactly,
    and a run with two failures still ends in the failure-free state."""
    make = lambda root, side="t": _trainer(
        setup, root, schedule={5: 1, 9: 2}, progress_mode="keyed", rng=7,
        side=side)
    a, b = make(tmp_path / "a"), make(tmp_path / "b")
    a.run(12)
    b.run(12)
    assert len(a.events) == 2
    assert a.energy.ledger_total_j() == b.energy.ledger_total_j()
    ea, eb = a.energy.events, b.energy.events
    assert [e.progress_frac for e in ea] == [e.progress_frac for e in eb]
    assert [e.saving_j for e in ea] == [e.saving_j for e in eb]
    assert all(0.0 <= p <= 1.0 for e in ea for p in e.progress_frac)
    assert len(ea[0].progress_frac) == 2
    ref = _trainer(setup, tmp_path / "c")
    ref.run(12)
    assert _state_equal(ref.state, a.state)
    j = make(tmp_path / "j", "j")
    j.run(12)
    assert [e.progress_frac for e in ea] == [e.progress_frac for e in j.energy.events]
    _assert_events_close(a.events, j.events)


def test_cold_restart_rolls_back_to_initial(R, tmp_path, setup):
    kw = dict(schedule={2: 1}, ckpt=dict(interval_steps=50))
    tr = _trainer(setup, tmp_path / "t", **kw)
    tr.run(4)
    ev = tr.events[0]
    assert ev["rollback_to"] == -1 and ev["reexec_steps"] == 2
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3]
    # the initial state the trainer kept is the caller's, untouched
    assert all(a is b for a, b in zip(leaves(tr._initial_state),
                                      leaves(setup["tstate"])))
    j = _trainer(setup, tmp_path / "j", side="j", **kw)
    j.run(4)
    _assert_events_close(tr.events, j.events)


def test_move_ahead_checkpoint_resets_sim_age(tmp_path, setup):
    tr = _trainer(setup, tmp_path, schedule={9: 0},
                  ckpt=dict(interval_steps=10, phase_offset_steps=1),
                  resync_on_recovery=False)
    tr.run(10)
    ev = tr.energy.events[0]
    assert all(d["move_ahead_ckpt"] for d in ev.decisions.values())
    for pod in ev.decisions:
        assert tr.managers[pod].move_aheads == 1
        assert tr.managers[pod].latest_step() == 8
        assert tr._sim_ckpt_age[pod] == 10.0
    assert tr.managers[0].move_aheads == 0
    assert tr.managers[0].latest_step() == 9


@pytest.mark.parametrize("reexec,frac,ages,wait_mode", [
    (1, 0.5, 0.0, 0), (200, 0.5, 0.0, 0), (5, 0.2, 1000.0, 1),
    (30, 0.9, 2500.0, 0), (0, 1.0, 3599.0, 1)])
def test_energy_manager_matches_reference(R, reexec, frac, ages, wait_mode):
    kw = dict(step=10, failed_pod=1, reexec_steps=reexec,
              ckpt_ages_s=np.full(4, ages), ckpt_duration_s=120.0,
              progress_frac=np.full(4, frac), gap_s=321.0)
    cl = dict(n_pods=4, step_time_s=10.0)
    got = T.EnergyManager(T.ClusterSpec(wait_mode=T.em.WaitMode(wait_mode), **cl),
                          device="cpu").on_failure(**kw)
    jem = R.ft_runtime.em
    want = R.ft_runtime.EnergyManager(R.ft_runtime.ClusterSpec(
        wait_mode=jem.WaitMode(wait_mode), **cl)).on_failure(**kw)
    _assert_decisions_close(got.decisions, want.decisions)
    for f in ("saving_j", "reference_j", "saving_pct", "intervention_s",
              "epoch_int_j", "epoch_ref_j", "gap_s", "t_e_s"):
        w = getattr(want, f)
        assert abs(getattr(got, f) - w) <= TOL_FLOAT * max(abs(w), 1.0), f
    assert (got.step, got.failed_pod, got.reexec_steps, got.progress_frac) == \
        (want.step, want.failed_pod, want.reexec_steps, want.progress_frac)


def test_energy_manager_decisions_scale_with_reexec():
    mgr = T.EnergyManager(T.ClusterSpec(n_pods=4, step_time_s=10.0), "cpu")
    kw = dict(step=10, failed_pod=0, ckpt_ages_s=np.zeros(4),
              ckpt_duration_s=120.0, progress_frac=np.full(4, 0.5))
    short = mgr.on_failure(reexec_steps=1, **kw)
    long = mgr.on_failure(reexec_steps=200, **kw)
    assert long.saving_j > short.saving_j
    assert all(d["wait_action"] == "SLEEP" for d in long.decisions.values())
    assert long.saving_pct > 60.0


def test_straggler_mitigation_matches_reference(R):
    kw = dict(step=5, slow_pod=1, delay_s=40.0, progress_frac=np.full(4, 0.2))
    ev = T.EnergyManager(T.ClusterSpec(n_pods=4, step_time_s=10.0),
                         "cpu").on_straggler(**kw)
    assert all(d["wait_action"] == "MIN_FREQ" for d in ev.decisions.values())
    assert ev.saving_j > 0
    want = R.ft_runtime.EnergyManager(R.ft_runtime.ClusterSpec(
        n_pods=4, step_time_s=10.0)).on_straggler(**kw)
    _assert_decisions_close(ev.decisions, want.decisions)
    assert abs(ev.saving_j - want.saving_j) <= TOL_FLOAT * want.saving_j


def test_energy_manager_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.EnergyManager(T.ClusterSpec())


def test_elastic_shrink_plan():
    with pytest.raises(ValueError, match="1-pod"):
        T.ElasticPlan.shrink({"pod": 1})
    plan = T.ElasticPlan.shrink({"pod": 3, "data": 2})
    assert plan.new_axes == {"pod": 2, "data": 2}
    assert plan.old_axes == {"pod": 3, "data": 2}
    # new_mesh / apply are ported: the shrunk mesh over a (fake) group
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.parallel.sharding import mesh_axes

    with fake_world(6):
        mesh, state = plan.apply({}, {}, device_type="cpu")
        assert mesh_axes(mesh) == {"pod": 2, "data": 2} and state == {}
        assert mesh_axes(plan.new_mesh(device_type="cpu")) == plan.new_axes


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

def _run_reference_cli(R, argv, monkeypatch):
    import repro.launch.train as jtrain
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    return out.getvalue().splitlines()


def _run_port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = ttrain.main(argv + ["--device", "cpu"])
    return trainer, out.getvalue().splitlines()


def test_train_cli_prints_the_reference_lines(R, tmp_path, monkeypatch):
    argv = ["--arch", ARCH, "--steps", "5", "--fail-at", "3", "--ckpt-every",
            "2", "--batch", "4", "--seq-len", "16"]
    trainer, got = _run_port_cli(argv + ["--ckpt-dir", str(tmp_path / "t")])
    want = _run_reference_cli(R, argv + ["--ckpt-dir", str(tmp_path / "j")],
                              monkeypatch)
    assert isinstance(trainer, T.FTTrainer) and len(trainer.history) == 5
    assert len(got) == len(want) == 2
    # the weights differ (each package draws its own), so the losses do;
    # the energy line is a function of the schedule alone
    strip = lambda s: s.split(", loss")[0]
    assert strip(got[0]) == strip(want[0]) == f"{ARCH}: 5 steps"
    assert got[1] == want[1]


def test_train_cli_adaptive(R, tmp_path, monkeypatch):
    argv = ["--adaptive", "--steps", "20", "--batch", "2", "--seq-len", "8"]
    trainer, got = _run_port_cli(argv + ["--ckpt-dir", str(tmp_path / "t")])
    want = _run_reference_cli(R, argv + ["--ckpt-dir", str(tmp_path / "j")],
                              monkeypatch)
    ctl = trainer.controller
    assert ctl is not None and ctl.retunes and trainer.events
    fails = lambda lines: [s.split(":")[0] for s in lines if "failure@" in s]
    assert fails(got) == fails(want)
    ledger = [s for s in got if s.startswith("ledger:")]
    assert ledger == [s for s in want if s.startswith("ledger:")]
    assert sum("retune@" in s for s in got) == len(ctl.retunes) == \
        sum("retune@" in s for s in want)


def test_train_cli_defaults_to_cuda_and_refuses_production_lower(monkeypatch):
    # --production-lower is ported since: it runs the port's dry run
    import subprocess

    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    with pytest.raises(SystemExit):
        ttrain.main(["--production-lower"])
    assert calls == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "deepseek-7b", "--shape", "train_4k"]]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])
