"""PyTorch port: the package stands alone.

``repro_torch``, ``chip_smoke.py`` and ``renewal_scan_ab.py`` import
neither ``jax`` nor any part of the reference package ``repro``; every
module imports with ``jax`` made unimportable, and importing them builds no
kernel.  The entry points that import lazily (the event oracle, the sweep,
the Monte-Carlo, the planners, both renewal engines, the correlated
``topology=`` sampler, the failure processes and the trace export, the
optimiser's entry points, the fleet advisor and the campaign runner and
CLI, the train step, the checkpoint manager, the FT trainer with its
adaptive controller and the training CLI, the moe and encoder-decoder
models through the serve and train entry points, gradient compression) run
with ``jax`` and ``repro`` unimportable too.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax_and_no_reference():
    files = [p for _, p in _modules()] + [ROOT / "chip_smoke.py",
                                          ROOT / "renewal_scan_ab.py"]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_every_module_imports_without_jax():
    mods = [m for m, _ in _modules()]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["repro"] = None
        for m in {mods!r}:
            importlib.import_module(m)
        from repro_torch.kernels import _build
        assert not _build._loaded, "importing must not build kernels"
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(mods) >= 15
    assert {"repro_torch.core.topology", "repro_torch.core.trace",
            "repro_torch.fleet", "repro_torch.fleet.advisor",
            "repro_torch.campaign", "repro_torch.campaign.__main__",
            "repro_torch.data.pipeline", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.manager", "repro_torch.ft",
            "repro_torch.ft.runtime", "repro_torch.ft.controller",
            "repro_torch.launch.train", "repro_torch._tree",
            "repro_torch.models.moe", "repro_torch.models.encdec",
            "repro_torch.parallel", "repro_torch.parallel.compression"} <= set(mods)


def test_entry_points_run_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.core import (failures, optimize, planning, prng,
                                      scenarios, simulator, sweep, topology,
                                      trace)
        cfgs = list(scenarios.paper_scenarios().values())
        rows, _, _ = simulator.compare(cfgs[0], device="cpu")
        run = simulator.simulate_run(cfgs[1], [4000.0, 9000.0], 3e4, device="cpu")
        res = sweep.sweep_scenarios(cfgs, np.linspace(0.3, 7000.3, 8),
                                    mu1=[4.0, 6.0], device="cpu")
        mc = sweep.monte_carlo(cfgs[2], prng.PRNGKey(0), n_samples=64, device="cpu")
        es = planning.expected_savings(cfgs[0].profile, ckpt_interval_s=1800.0,
                                       t_down_s=60.0, t_restart_s=60.0,
                                       comp_to_block_s=300.0, grid=16,
                                       device="cpu")
        for engine in ("scan", "kernel"):
            sweep.renewal_monte_carlo_scenarios(cfgs, prng.PRNGKey(1), n_runs=8,
                                                max_failures=4, engine=engine,
                                                device="cpu")
        grid = optimize.evaluate_policy_grid(
            scenarios.sparse_rendezvous_scenario(),
            optimize.policy_grid(ckpt_interval=[3600.0, 7200.0]),
            prng.PRNGKey(2), work_s=1e5, n_runs=8, max_failures=4,
            mtbf_s=1e4, device="cpu")
        topo = topology.rack_topology(4, 4, shock_mtbs_s=2e5, p_kill=0.9)
        for engine in ("host", "device", "kernel"):
            sweep.renewal_monte_carlo(cfgs[3], prng.PRNGKey(3), n_runs=8,
                                      max_failures=4, topology=topo,
                                      process=failures.Gamma.from_mtbf(0.5, 3e5),
                                      engine=engine, device="cpu")
        failures.fit_weibull([1.0, 2.0, 5.0], censored=[3.0])
        from repro_torch import fleet
        from repro_torch.campaign import __main__ as campaign_cli
        from repro_torch.campaign import presets, runner
        small = optimize.policy_grid(ckpt_interval=[3600.0, 7200.0])
        opt = optimize.optimize_policy(
            scenarios.sparse_rendezvous_scenario(), table=small, work_s=1e5,
            mtbf_s=1e4, n_runs=4, max_failures=3, refine=True,
            cem_kw={"n_iters": 1, "population": 2}, device="cpu")
        panel = optimize.optimize_across_processes(
            scenarios.sparse_rendezvous_scenario(), table=small, work_s=1e5,
            mtbf_s=1e4, n_runs=4, max_failures=3, device="cpu")
        adv = fleet.FleetAdvisor(small, n_runs=4, max_failures=3,
                                 device="cpu").advise(fleet.synthetic_fleet(3))
        camp = runner.run_campaign(presets.smoke(), device="cpu")
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()) as listing:
            assert campaign_cli.main(["list"]) == 0
        assert "policy_grid" in listing.getvalue()
        assert opt.cem is not None and len(panel) == 3 and len(adv) == 3
        assert camp.n_computed == 4
        prv = trace.to_prv(simulator.simulate(cfgs[0], True, device="cpu"))
        assert prv.startswith("#Paraver")
        assert len(rows) == 3 and run.n_failures == 2 and mc.n_samples == 64
        assert tuple(res.decision.level.shape) == (6, 2, 8, 3)
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok", es.grid, len(grid))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 16 2")


def test_training_entry_points_run_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import contextlib, io, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.launch import train
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tr = train.main(["--steps", "4", "--fail-at", "2", "--ckpt-every",
                             "1", "--batch", "2", "--seq-len", "8",
                             "--device", "cpu", "--ckpt-dir", {str(tmp_path / "a")!r}])
            ad = train.main(["--adaptive", "--steps", "6", "--batch", "2",
                             "--seq-len", "8", "--device", "cpu",
                             "--ckpt-dir", {str(tmp_path / "b")!r}])
        from repro_torch.ft import reconcile_ledger
        rep = reconcile_ledger(ad, device="cpu")
        assert tr.events[0]["rollback_to"] == 1 and len(tr.history) == 4
        assert rep.n_failures == len(ad.events) > 0
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok", len(out.getvalue().splitlines()) > 2)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok True")


def test_moe_and_encdec_entry_points_run_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import contextlib, io, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import serve, steps, train
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import adamw
        from repro_torch.parallel.compression import (CompressionConfig,
                                                      wrap_optimizer)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            for arch in ("olmoe-1b-7b", "whisper-medium"):
                serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "3",
                            "--gen", "3", "--device", "cpu"])
            tr = train.main(["--arch", "mixtral-8x22b", "--steps", "2",
                             "--batch", "2", "--seq-len", "8", "--pods", "2",
                             "--device", "cpu", "--ckpt-dir", {str(tmp_path)!r}])
        cfg = get_smoke_config("whisper-medium")
        model = build_model(cfg, device="cpu")
        opt = wrap_optimizer(adamw(), CompressionConfig(method="int8"))
        params = model.init(0)
        g = torch.Generator().manual_seed(0)
        batch = {{"frames": torch.randn((2, cfg.encdec.enc_len, cfg.d_model),
                                       generator=g),
                 "tokens": torch.randint(0, 256, (2, 8), generator=g),
                 "labels": torch.randint(0, 256, (2, 8), generator=g)}}
        p, s, m = steps.make_train_step(model, opt)(params, opt.init(params),
                                                    batch)
        assert len(tr.history) == 2 and set(s) == {{"base", "residual"}}
        assert bool(torch.isfinite(m["total_loss"]))
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok", len(out.getvalue().splitlines()))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 3")
