"""Time two builds of the SSD-scan kernels on one NVIDIA GPU, in turns.

    python3 ssd_scan_ab.py --baseline DIR [--rounds 2]

Builds this checkout's ``src/repro_torch/kernels/csrc/ssd_scan.cu`` and
the same file of another checkout ``DIR`` (a commit unpacked with
``git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR``; its
shared headers come from the same directory), both with this checkout's
flags, one nvcc each, started together.  At four bf16 shapes
(``SHAPES``: zamba2-7b's prefill call, mamba2-370m's (P, N) = (64, 128) at
the same batch, heads and length, zamba2's heads over four groups of B
and C, and one (batch, head) of 64 chunks: the fused chunk state's chain
alone, 63 links one after another) it makes seeded operands as
``chip_smoke.py`` does, holds both
builds within ``TOL_SSD`` of the plain version (y and the final state),
times each whole call with ``chip_smoke.py``'s ``kernel_only_ms`` in the
order baseline, this, this, baseline, per round, and profiles one call of
each build for the device time of its three parts (chunk state, state
passing, chunk scan), the kernel that ran each, and the chunk state and
state passing together (``state_ms``: one fused kernel, or two).  Prints
each build's ptxas lines for the SSD kernels, one ``[ab]`` and two
``[ab-parts]`` lines per shape with the bound (bytes or flop at the card's
peaks), and the card as ``nvidia-smi`` names it.  Exits non-zero without a result when
no CUDA device is present or a build disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# label -> (batch, heads, groups, length, P, N, chunk)
SHAPES = {
    "zamba2": (2, 112, 1, 4096, 64, 64, 256),
    "pn-64x128": (2, 112, 1, 4096, 64, 128, 256),
    "groups-4": (2, 112, 4, 4096, 64, 64, 256),
    "chain-63": (1, 1, 1, 64 * 256, 64, 64, 256),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    card_line = cs.card()
    base_csrc = args.baseline / "src" / "repro_torch" / "kernels" / "csrc"
    name, source, flags = ssd.LIBRARY
    with ThreadPoolExecutor(max_workers=2) as pool:
        base_job = pool.submit(_build.load_library, f"{name}_baseline", source,
                               flags, base_csrc)
        _build.load_library(*ssd.LIBRARY)
        base_lib = base_job.result()
    for label in (name, f"{name}_baseline"):
        for fn in cs.ptxas_functions(_build.build_log[label]["ptxas"]):
            if fn["function"].startswith("ssd_"):
                cs.line("build", library=label, **fn)

    dev = torch.device("cuda")
    for i, (label, (b, h, g, s, p, n, chunk)) in enumerate(SHAPES.items()):
        ops = cs.ssd_operands(b, h, g, s, p, n, torch.bfloat16, 400 + i, dev)
        this = lambda: ssd.ssd_scan_bhsp(*ops, chunk=chunk)
        base = lambda: ssd._launch_cuda(*ops, chunk, lib=base_lib)
        y_p, st_p = ssd.ssd_scan_reference(*ops, chunk=chunk)
        errs = {}
        for who, fn in (("this", this), ("baseline", base)):
            y, st = fn()
            torch.cuda.synchronize()
            errs[who] = max(cs.check_close(f"{label} {who} y", y, y_p, *cs.TOL_SSD),
                            cs.check_close(f"{label} {who} state", st, st_p,
                                           *cs.TOL_SSD))
        del y_p, st_p
        times = {"baseline": [], "this": []}
        for _ in range(args.rounds):
            for who in ("baseline", "this", "this", "baseline"):
                ms, _ = cs.kernel_only_ms(base if who == "baseline" else this,
                                          cs.LM_KERNEL_REPS)
                times[who].append(ms)
        flop = cs.ssd_work(ops[0], ops[3], chunk)
        bound_ms, bound_by = cs.bound(cs.nbytes(*ops, y, st), flop, ops[0].dtype)
        med = {who: statistics.median(t) for who, t in times.items()}
        cs.line("ab", shape=label, card=repr(card_line), x=tuple(ops[0].shape),
                bc=tuple(ops[3].shape), chunk=chunk,
                kernel=f"{ssd.chunk_state_kernel(p, n, chunk)}<{p},{n}>+"
                       f"{ssd.chunk_scan_kernel(p, n, chunk)}<{p},{n}>",
                baseline_ms=[f"{t:.5f}" for t in times["baseline"]],
                this_ms=[f"{t:.5f}" for t in times["this"]],
                baseline_median_ms=f"{med['baseline']:.5f}",
                this_median_ms=f"{med['this']:.5f}",
                speedup=f"{med['baseline'] / med['this']:.3f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                bound_share_this=f"{bound_ms / med['this']:.4f}",
                flop=f"{flop:.4e}", bytes=cs.nbytes(*ops, y, st),
                max_abs_err_this=f"{errs['this']:.3e}",
                max_abs_err_baseline=f"{errs['baseline']:.3e}")
        for who, fn in (("baseline", base), ("this", this)):
            prof = cs.device_profile(fn)
            if prof["device_ms"] is None:
                cs.line("ab-parts", shape=label, build=who,
                        device_time="not measured (the trace holds no device time)")
                continue
            parts = prof["ssd_parts"]
            cs.line("ab-parts", shape=label, build=who, card=repr(card_line),
                    **{f"{k}_ms": f"{v:.5f}" for k, v in parts.items()
                       if k != "float32"},
                    state_ms=f"{parts['chunk_state'] + parts['state_pass']:.5f}",
                    **{f"{k}_kernel": "+".join(v)
                       for k, v in prof["ssd_kernels"].items()})
        if label == "zamba2":
            cs.line("clocks", during=f"{label} x100 (this build)",
                    card=repr(card_line),
                    sm_clock_max_clock_power_temperature=repr(
                        cs.loaded_clocks(this, 100)))
        del ops, y, st
        torch.cuda.empty_cache()
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
