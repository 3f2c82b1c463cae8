"""Time two builds of the flash-attention kernel on one NVIDIA GPU, in turns.

    python3 flash_attention_ab.py --baseline DIR [--rounds 2]

Builds this checkout's ``src/repro_torch/kernels/csrc/flash_attention.cu``
and the same file of another checkout ``DIR`` (a commit unpacked with
``git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR``; its
shared headers come from the same directory), both with this checkout's
flags, one nvcc each, started together.  At the five bf16 launches of the
LM paths (``PATH_SHAPES``: zamba2-7b's and deepseek-7b's prefill heads,
olmoe-1b-7b's, mixtral-8x22b's window-4096 launch at group 6, whisper-
medium's decoder) it makes seeded operands as ``chip_smoke.py`` does, holds
both builds within ``PLAIN_TOL`` of the plain version (mixtral's per KV
head), and times each with ``chip_smoke.py``'s ``kernel_only_ms`` in the
order baseline, this, this, baseline, per round; beside them it times
``scaled_dot_product_attention`` on the same operands (causal, or the
window as a boolean mask) and gives the bound (the mask's kept pairs at
4 d flop each, or the bytes, at the card's peaks) and this kernel's
issued-work ceiling (6 d flop per kept pair).  Prints each build's ptxas
lines for the flash kernels, one ``[ab]`` line per shape with every time
and the card as ``nvidia-smi`` names it, and the SM clock under the
zamba2 launch's load.  Exits non-zero without a result when no CUDA device
is present or a build disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# label -> (batch, query heads, KV heads, length, head dim, window)
PATH_SHAPES = {
    "zamba2": (2, 32, 32, 4096, 112, None),
    "deepseek": (2, 32, 32, 4096, 128, None),
    "olmoe": (2, 16, 16, 4096, 128, None),
    "mixtral": (2, 48, 8, 8192, 128, 4096),
    "whisper": (8, 16, 16, 448, 64, None),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card_line = cs.card()
    base_csrc = args.baseline / "src" / "repro_torch" / "kernels" / "csrc"
    name, source, flags = fa.LIBRARY
    with ThreadPoolExecutor(max_workers=2) as pool:
        base_job = pool.submit(_build.load_library, f"{name}_baseline", source,
                               flags, base_csrc)
        _build.load_library(*fa.LIBRARY)
        base_lib = base_job.result()
    for label in (name, f"{name}_baseline"):
        for fn in cs.ptxas_functions(_build.build_log[label]["ptxas"]):
            if "mma_kernel" in fn["function"]:
                cs.line("build", library=label, **fn)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (label, (b, h, kh, s, d, window)) in enumerate(PATH_SHAPES.items()):
        group = h // kh
        q, k, v = cs.flash_operands(b, h, kh, s, d, torch.bfloat16, 300 + i, dev)
        kw = {"group": group, "window": window}
        this = lambda: fa.flash_attention_bhsd(q, k, v, **kw)
        base = lambda: fa._launch_cuda(q, k, v, group, True, window,
                                       lib=base_lib)
        want = torch.cat([fa.flash_attention_reference(
            q[j * group:(j + 1) * group], k[j:j + 1], v[j:j + 1], **kw)
            for j in range(k.shape[0])])
        errs = {}
        for who, fn in (("this", this), ("baseline", base)):
            out = fn()
            torch.cuda.synchronize()
            errs[who] = cs.check_close(f"{label} {who}", out, want,
                                       *fa.PLAIN_TOL[torch.bfloat16])
        del want
        times = {"baseline": [], "this": []}
        for _ in range(args.rounds):
            for who in ("baseline", "this", "this", "baseline"):
                ms, _ = cs.kernel_only_ms(base if who == "baseline" else this,
                                          cs.LM_KERNEL_REPS)
                times[who].append(ms)
        sdpa_ms = cs.sdpa_timing(label, card_line, (q, k, v), kw, h, out)
        flop = cs.flash_work(q, k, window)
        bound_ms, bound_by = cs.bound(cs.nbytes(q, k, v, out), flop, q.dtype)
        med = {who: statistics.median(t) for who, t in times.items()}
        cs.line("ab", shape=label, card=repr(card_line), q=tuple(q.shape),
                kv=tuple(k.shape), group=group, window=window,
                kernel=f"{fa.BF16_KERNEL[d]}<{d}>",
                baseline_ms=[f"{t:.5f}" for t in times["baseline"]],
                this_ms=[f"{t:.5f}" for t in times["this"]],
                baseline_median_ms=f"{med['baseline']:.5f}",
                this_median_ms=f"{med['this']:.5f}",
                speedup=f"{med['baseline'] / med['this']:.3f}",
                sdpa_ms=f"{sdpa_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
                bound_by=bound_by,
                issued_ceiling_ms=cs.flash_issued_ms(q, k, window),
                flop=f"{flop:.4e}",
                max_abs_err_this=f"{errs['this']:.3e}",
                max_abs_err_baseline=f"{errs['baseline']:.3e}")
        if label == "zamba2":
            cs.line("clocks", during=f"{label} x100 (this build)",
                    card=repr(card_line),
                    sm_clock_max_clock_power_temperature=repr(
                        cs.loaded_clocks(this, 100)))
        del q, k, v, out
        torch.cuda.empty_cache()
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
