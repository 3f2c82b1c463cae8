"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 portbench/control.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault-seeds <n> ...]

For every seed the first ``sample_prefills`` batches of the cell's mix go
whole through the timed path (the port's prefill step), and each batch's
``sample_prompts`` prompts, evenly spaced (all, where the limits do not
say), through the plain float32 reference, as a run checks them:

* ``program`` (``--seeds``): the port against the reference — the lower
  readings;
* ``control`` (``--control-seeds``): the reference computed with float8
  products (``precision="fp8"``), the step below the configuration's
  bfloat16, against the float32 reference — the upper readings;
* ``fault:<name>`` (``--fault-seeds``): the port with each fault of
  ``lib/faults.py`` planted under the step.

Prints one JSON line per (seed, kind) with each number of ``lib/check.py``
(the worst prompt's), then a summary line: per number the largest program
reading, and the smallest reading of the control and of each fault.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, control_seeds=(), fault_seeds=(), *, device="cuda",
             dims=None, mix=None, emit=lambda row: None) -> dict:
    """Per kind, per number, every seed's reading; ``emit`` sees each
    seed's line.  ``dims`` and ``mix`` replace the cell's sizes (the CPU
    tests)."""
    import numpy as np
    import torch

    from portbench.lib import check, faults, runner
    from portbench.lib.traffic import make_pool

    dev = torch.device(device)
    dims = cell.config.dims(cell.config_doc) if dims is None else dims
    mix = cell.traffic if mix is None else mix
    vocab = dims["vocab"]
    k = int(cell.limits["sample_prefills"])
    n = min(int(cell.limits.get("sample_prompts", mix["batch"])), int(mix["batch"]))
    rows = torch.arange(n) * (int(mix["batch"]) // n)     # across the batch
    out: dict = {}

    def record(seed, kind, got):
        """One reading of ``got`` against this seed's ``ref``."""
        per_row = check.row_numbers(got, ref)
        row = {"seed": seed, "kind": kind, **check.numbers(per_row, kept)}
        for name in check.NUMBERS:
            out.setdefault(kind, {}).setdefault(name, []).append(row[name])
        row["prompts"] = {name: [float(v) for v in values]
                          for name, values in per_row.items()}
        row["prompts"]["kept"] = [bool(k) for k in kept]
        if margin:
            row["prompts"]["tie_margin"] = margin
        emit(row)

    def logits(fn, batches):
        return torch.cat([fn(b)[:, :vocab].float().cpu() for b in batches]).numpy()

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        step, weights = runner.build(cell, seed, dev, dims)
        pool = make_pool(mix, vocab, seed, dev)
        batches = [pool[i] for i in range(k)]
        refs = [runner.reference(cell, weights, b[rows], dims) for b in batches]
        ref = np.concatenate([r for r, _ in refs])
        kept = runner.kept_rows(cell.limits, refs)
        margin = [float(v) for _, m in refs if m is not None for v in m]
        if seed in seeds:
            record(seed, "program", logits(
                lambda b: step(weights, {"tokens": b})[rows], batches))
        for fault in faults.FAULTS if seed in fault_seeds else ():
            broken = faults.wrap(step, fault, vocab)
            record(seed, f"fault:{fault}", logits(
                lambda b: broken(weights, {"tokens": b})[rows], batches))
        if seed in control_seeds:
            record(seed, "control", logits(
                lambda b: cell.reference.forward(weights, b[rows], dims,
                                                 precision="fp8"), batches))
        del step, weights, pool
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    from portbench.lib import spec

    cell = spec.cell(args.workload)
    found = readings(cell, args.seeds, args.control_seeds, args.fault_seeds,
                     emit=lambda row: print(json.dumps(row), flush=True))
    summary = {kind: {name: (max(v) if kind == "program" else min(v))
                      for name, v in numbers.items()}
               for kind, numbers in found.items()}
    print(json.dumps({"workload": cell.name, "summary": summary,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
