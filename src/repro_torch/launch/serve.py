"""Serve CLI: batched greedy decode on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --device cpu

The smoke config of ``--arch``.  Weights are drawn from seed 0 and prompts
from seed 1; the batch is padded up to a shape bucket (the padded rows
repeat the last prompt) and sliced back before the report.  ``--device``
defaults to ``cuda`` and raises without a card.  ``--production-lower``
belongs to the dry-run, which is not ported yet; the reference's
``--shape``, which only that option reads, comes with it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.launch.batching import DEFAULT_BUCKETS, bucket_size, pad_rows

PRODUCTION_LOWER = ("ROADMAP.md, Queue 1: 'Distribution and launch tooling' "
                    "(the dry-run and production lowering)")


def serve(model, params, prompts: np.ndarray, gen: int) -> dict:
    """Greedy decode of ``gen`` tokens after feeding ``prompts`` (B, T)
    token by token; the batch is padded to its bucket and sliced back.
    Returns the tokens (B, gen), the bucket and the decode rate (tokens of
    the real rows per second over the generated steps, host clock, device
    synchronised)."""
    from repro_torch.launch.steps import make_serve_step

    n, prompt_len = prompts.shape
    bucket = bucket_size(n, DEFAULT_BUCKETS)
    dev = model.device
    padded = torch.as_tensor(pad_rows(prompts, bucket), dtype=torch.int32,
                             device=dev)
    step = make_serve_step(model)
    cache = model.init_cache(bucket, prompt_len + gen)
    tok = None
    for t in range(prompt_len):
        tok, cache = step(params, cache, padded[:, t:t + 1], t)
    out = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len, prompt_len + gen - 1):
        tok, cache = step(params, cache, out[-1][:, None], t)
        out.append(tok)
    tokens = torch.stack(out, dim=1)[:n].cpu().numpy()     # synchronises
    dt = time.perf_counter() - t0
    return {"tokens": tokens, "bucket": bucket,
            "tokens_per_s": n * (gen - 1) / dt if gen > 1 else float("nan")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--production-lower", action="store_true")
    args = ap.parse_args(argv)

    if args.production_lower:
        raise NotImplementedError(
            f"--production-lower is not ported yet ({PRODUCTION_LOWER})")

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    res = serve(model, params, prompts, args.gen)
    print(f"{args.arch}: {args.batch}x{args.gen} tokens "
          f"(bucket {res['bucket']}), {res['tokens_per_s']:.0f} tok/s; "
          f"first row {res['tokens'][0, :8].tolist()}")


if __name__ == "__main__":
    main()
