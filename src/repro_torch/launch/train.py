"""Training CLI, the counterpart of ``repro.launch.train``.

Trains the smoke config of ``--arch`` through the full FT/energy runtime
(uncoordinated pod-local checkpoints, failure injection, localized
rollback and re-execution, Algorithm-1 decisions for the survivors) with
AdamW on synthetic tokens; ``--adaptive`` draws failures from a Weibull
process and runs the online adaptive energy controller.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
        --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --adaptive --device cpu

Weights come from seed 0; every decoder arch trains (the encoder-decoder
needs audio frames the synthetic pipeline does not draw, and is refused).
``--device`` defaults to ``cuda`` and raises without a card.
Checkpoints go to ``--ckpt-dir`` (default: a new temporary directory).
``--production-lower`` runs the dry run of ``--arch`` x ``--shape``
(default ``train_4k``) on the production mesh in a subprocess
(``launch.serve.production_lower``) and exits with its code.
"""
from __future__ import annotations

import argparse
import tempfile

def main(argv=None):
    """Run the CLI; returns the finished ``FTTrainer`` (its controller, if
    any, is ``trainer.controller``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--fail-pod", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--production-lower", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    # online adaptive mode: stochastic failures + observe->fit->retune loop
    ap.add_argument("--adaptive", action="store_true",
                    help="draw failures from a Weibull process and run the "
                         "online adaptive energy controller")
    ap.add_argument("--mtbf", type=float, default=2000.0,
                    help="per-node MTBF seconds for --adaptive")
    ap.add_argument("--weibull-k", type=float, default=0.7)
    ap.add_argument("--step-time", type=float, default=100.0,
                    help="simulated step wall seconds for --adaptive")
    ap.add_argument("--failure-key", type=int, default=3)
    ap.add_argument("--retune-every", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_lower:
        from repro_torch.launch.serve import production_lower
        raise SystemExit(production_lower(args.arch, args.shape))

    from repro_torch.checkpoint.manager import CheckpointConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft.runtime import ClusterSpec, FailureInjector, FTTrainer
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw

    cfg = get_smoke_config(args.arch)
    if cfg.family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: the synthetic pipeline draws tokens only; "
            "the encoder-decoder trains through launch.steps.make_train_step "
            "on batches with 'frames'")
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    opt = adamw(AdamWConfig(learning_rate=3e-4))
    state = (params, opt.init(params))
    step_fn = make_train_step(model, opt)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                       global_batch=args.batch, device=args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    if args.adaptive:
        from repro_torch.core import prng
        from repro_torch.core.failures import Weibull
        from repro_torch.ft.controller import (AdaptiveController,
                                               StochasticFailureInjector)
        process = Weibull.from_mtbf(args.weibull_k, args.mtbf)
        injector = StochasticFailureInjector(
            process, prng.PRNGKey(args.failure_key), n_pods=args.pods,
            device=args.device)
        controller = AdaptiveController(
            process, n_pods=args.pods, retune_every=args.retune_every,
            device=args.device)
        cluster = ClusterSpec(n_pods=args.pods, step_time_s=args.step_time)
        ckpt_cfg = CheckpointConfig(root=ckpt_dir,
                                    interval_steps=args.ckpt_every,
                                    phase_offset_steps=1)
    else:
        schedule = {}
        if args.fail_at is not None:
            schedule[args.fail_at] = args.fail_pod
        injector = FailureInjector(schedule)
        controller = None
        cluster = ClusterSpec(n_pods=args.pods)
        ckpt_cfg = CheckpointConfig(root=ckpt_dir,
                                    interval_steps=args.ckpt_every)
    trainer = FTTrainer(
        step_fn=step_fn, pipeline=pipe, state=state, cluster=cluster,
        ckpt_cfg=ckpt_cfg, injector=injector, controller=controller,
        device=args.device)
    hist = trainer.run(args.steps)
    print(f"{args.arch}: {len(hist)} steps, "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
          f"checkpoints in {ckpt_dir}")
    for ev in trainer.events:
        print(f"  failure@{ev['step']} pod{ev['pod']}: saved "
              f"{ev['saving_j'] / 1e3:.1f} kJ ({ev['saving_pct']:.1f}%)")
    if controller is not None:
        print(f"ledger: {trainer.energy.ledger_total_j() / 1e6:.3f} MJ over "
              f"{trainer.sim_balanced_s:.0f} balanced s, "
              f"{len(trainer.events)} failures")
        for r in controller.retunes:
            print(f"  retune@{r.step} ({r.n_observed} gaps, "
                  f"{r.process_label}): interval "
                  f"{r.policy['ckpt_interval']:.0f}s mu1 "
                  f"{r.policy['mu1']:.1f} wait {r.policy['wait_mode']} "
                  f"[{r.wall_s:.2f}s]")
    return trainer


if __name__ == "__main__":
    main()
