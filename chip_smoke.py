"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from the sources in this checkout (one
nvcc each, all started together) and holds each against its plain PyTorch
version on the card.  Then it drives the port's two paths at the size users
run them, each with the launch counts set to 0 just before it and read just
after, and holds launches of each path against the plain version on the
same operands:

* the renewal Monte-Carlo over the paper's six Table-4 scenarios, the
  42-policy grid and Weibull failures, checked against the port's float64
  host oracle (``renewal_scan``; before them the kernel is held bit-equal
  to its plain version at 1-4 survivors, 1-4 ladder levels, K 1 and 64,
  R 1, 31 and 1000: ``[kernel-shapes]``);
* Zamba2-7B serving at its published widths with seeded weights: a bf16
  prefill of 2 x 4096 tokens (13 ``flash_attention`` and 81 ``ssd_scan``
  launches), a float32 prefill of 2 x 512 tokens against the same tokens
  decoded one at a time and against the plain path, and the serve loop
  (batch 4, prompt 16, 32 generated tokens).

It times each kernel alone, its plain version, its bound, the one-call
PyTorch equivalent where there is one (SDPA for flash attention), and the
entry points whole; it prints each compiled kernel's registers and spills
(``[build]``, from ptxas), each kernel's resident blocks per SM
(``[occupancy]``, from CUDA's occupancy calculator) and the SM clock under
load beside the timings (``[clocks]``).  Every phase prints one line; any
failure exits non-zero.  The last four lines are the card, the kernel record (JSON), the
list of kernels, and ``{"ok": true, "device": ...}``.  Exits non-zero
without a result when no CUDA device is present, or when the rest of the
repository is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM3 bandwidth, float32 outside the tensor cores, dense bf16 on
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# analytic cost of one occurring (epoch, survivor) decision of the renewal
# kernel (benchmarks/failure_sweep.py, roofline methodology)
FLOP_PER_DECISION = 190.0

FULL_RUNS = 4096
FULL_EPOCHS = 64
MAKESPAN_S = 30 * 24 * 3600.0
MTBF_S = 14 * 24 * 3600.0
GRID_WORK_S = 2 * 24 * 3600.0
GRID_MTBF_S = 8 * 3600.0
ORACLE_RUNS = 256
WEIBULL_RUNS = 1024
KERNEL_REPS = 20          # launches queued back to back per kernel timing
TOL_ORACLE = 1e-4          # whole-run energies vs the float64 oracle
TOL_PLAIN = 1e-6           # kernel vs its plain version (bit-equal expected)
# the renewal kernel's shape sweep: survivors x ladder levels x (K, R)
SHAPE_KR = ((1, 1), (1, 31), (1, 1000), (FULL_EPOCHS, 1), (FULL_EPOCHS, 31),
            (FULL_EPOCHS, 1000))
FLOAT_STATS = ("energy_ref", "energy_int", "saving", "balanced_energy",
               "end_time")

# the LM serving path: zamba2-7b at its published widths
LM_ARCH = "zamba2-7b"
PREFILL_BATCH, PREFILL_LEN = 2, 4096
DECODE_CHECK_LEN = 512     # two SSD chunks, eight flash query blocks
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
LM_KERNEL_REPS = 10
# flash attention against its plain version: the kernel module's
# PLAIN_TOL (2e-5 in float32; atol 1e-4 / rtol 1e-2, one bf16 ulp, in
# bf16).  tests/test_kernels.py's bars: the SSD scan atol 2e-3 / rtol
# 1e-3; decode against the forward tests/test_models.py's
# test_decode_matches_forward (5e-3 / 1e-3)
TOL_SSD = (2e-3, 1e-3)
TOL_DECODE = (5e-3, 1e-3)
# kernels of one bf16 ssd_scan call (csrc/ssd_scan.cu ssd_kernel_<part>);
# a float32 call runs ssd_kernel alone
SSD_PARTS = ("chunk_state", "state_pass", "chunk_scan", "float32")


class Failed(RuntimeError):
    pass


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise Failed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def loaded_clocks(launch, n: int) -> str:
    """nvidia-smi's SM clock (and its maximum), power draw and temperature,
    sampled while ``n`` launches queued back to back keep the card busy:
    two cards of one model and power limit can still run at other clocks."""
    for _ in range(n):
        launch()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    if out.returncode != 0:
        return f"not read ({out.stderr.strip()[:80]})"
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> list:
    """Per-call milliseconds of ``fn`` (CUDA events, synchronised each
    call): the stream is idle at the start event, so the host's time up to
    the first launch counts too — what a caller of ``fn`` waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def kernel_only_ms(launch, n: int) -> tuple:
    """Median device milliseconds of one kernel launch, the wrapper's host
    time excluded, and the wrapper's host milliseconds per call.  A spin
    kernel holds the stream while the host queues ``n`` launches, each
    between two CUDA events; they then run back to back.  Fails if the host
    had not queued them all before the hold ended."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    hold = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    hold[0].record()
    torch.cuda._sleep(1_000_000)
    hold[1].record()
    torch.cuda.synchronize()
    ms_per_cycle = hold[0].elapsed_time(hold[1]) / 1e6
    hold_ms = max(20.0, 4 * n * host_ms)
    hold[0].record()
    torch.cuda._sleep(int(hold_ms / ms_per_cycle))
    hold[1].record()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(n):
        launch()
        ev[i + 1].record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    held_ms = hold[0].elapsed_time(hold[1])
    if queued_ms >= held_ms:
        raise Failed(f"kernel timing: the host took {queued_ms:.3f} ms to "
                     f"queue {n} launches, longer than the {held_ms:.3f} ms "
                     f"hold")
    return statistics.median(
        ev[i].elapsed_time(ev[i + 1]) for i in range(n)), host_ms


@contextlib.contextmanager
def recorded(module, name: str, pick=lambda i, *call: call):
    """Stands in for ``module.name`` while a path runs: forwards every call
    and yields a list that gets ``pick(i, args, kw, out)`` of the i-th call
    (by default the whole call), so launches of the path can be held
    against the plain version on the operands the path gave them."""
    fn = getattr(module, name)
    calls: list = []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        calls.append(pick(len(calls), args, kw, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def drive(rs, fn) -> tuple:
    """Run one entry point with the launch counts set to 0 just before it;
    returns (its result, the kernel launches it made, the recorded calls).
    Fails if it launched the kernel no time, or other than once per call."""
    rs.reset_launch_counts()
    # the caller edits the kernel's output dict: keep a copy
    with recorded(rs, "renewal_scan",
                  lambda i, args, kw, out: (args, kw, dict(out))) as calls:
        result = fn()
    torch.cuda.synchronize()
    launches = rs.LAUNCHES["renewal_scan"]
    if launches < 1:
        raise Failed("the path did not launch the renewal_scan kernel")
    if launches != len(calls):
        raise Failed(f"{launches} launches for {len(calls)} kernel calls")
    return result, launches, calls


def check_summary(name: str, sm, out: dict, s: int) -> None:
    """The printed summary is the reduction of the checked kernel stats."""
    for got, want in (
            (sm.mean_failures, out["n_failures"][s].double().mean()),
            (sm.mean_energy_ref_j, out["energy_ref"][s].double().mean()),
            (sm.mean_energy_int_j, out["energy_int"][s].double().mean()),
            (sm.mean_saving_j, out["saving"][s].double().mean())):
        if abs(got - float(want)) > 1e-9 * abs(float(want)):
            raise Failed(f"{name}: summary {got!r} is not the mean of the "
                         f"kernel's stats ({float(want)!r})")


def compare_outputs(got: dict, want: dict) -> tuple:
    """Exact integer stats and valid mask; float stats within TOL_PLAIN
    relative.  Returns (max_abs_err, max_rel_err) over the float stats."""
    max_abs = max_rel = 0.0
    for name, w in want.items():
        g = got[name]
        if name in FLOAT_STATS:
            d = (g.double() - w.double()).abs()
            rel = d / w.double().abs().clamp_min(1e-30)
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float(rel.max()))
            if not torch.isfinite(g).all():
                raise Failed(f"kernel {name} has non-finite values")
        elif not torch.equal(g, w):
            n_bad = int((g != w).sum())
            raise Failed(f"kernel {name} differs from the plain version "
                         f"at {n_bad} entries")
    if max_rel > TOL_PLAIN:
        raise Failed(f"kernel floats differ from the plain version: "
                     f"max rel {max_rel:.3e} > {TOL_PLAIN}")
    return max_abs, max_rel


def check_against_oracle(phase, sweep, cfg, stats_row: dict, gaps, failed,
                         makespan_s, per_run: bool = True) -> tuple:
    """The first ORACLE_RUNS runs against the float64 host oracle on the same
    histories: failure counts exact per run; energies within TOL_ORACLE
    relative per run (``per_run``) or on their mean over the runs (the
    policy grid's output, the expected energy per policy); the saving within
    TOL_ORACLE of the reference energy.  Returns (gated error, worst
    per-run relative error, runs above TOL_ORACLE)."""
    host = sweep.renewal_compose(cfg, gaps, makespan_s, failed_node=failed,
                                 device="cpu")
    n_fail = stats_row["n_failures"][:ORACLE_RUNS].cpu().long()
    if not torch.equal(n_fail, host.n_failures):
        raise Failed(f"{phase} {cfg.name}: failure counts differ from the oracle")
    gated = worst_run = 0.0
    n_over = 0
    for field in ("energy_ref", "energy_int", "balanced_energy", "end_time"):
        if field not in stats_row:
            continue
        k = stats_row[field][:ORACLE_RUNS].double().cpu()
        h = getattr(host, field)
        rel = (k - h).abs() / h.abs()
        worst_run = max(worst_run, float(rel.max()))
        n_over = max(n_over, int((rel > TOL_ORACLE).sum()))
        err = float(rel.max()) if per_run else abs(float(k.mean() / h.mean()) - 1)
        gated = max(gated, err)
        if err > TOL_ORACLE:
            raise Failed(f"{phase} {cfg.name} {field}: rel {err:.3e} > "
                         f"{TOL_ORACLE} against the float64 oracle")
    sav = stats_row["saving"][:ORACLE_RUNS].double().cpu()
    if per_run:
        sav_err = float(((sav - host.saving).abs() / host.energy_ref).max())
    else:
        sav_err = abs(float((sav.mean() - host.saving.mean())
                            / host.energy_ref.mean()))
    if sav_err > TOL_ORACLE:
        raise Failed(f"{phase} {cfg.name} saving: {sav_err:.3e} of "
                     f"energy_ref > {TOL_ORACLE}")
    return max(gated, sav_err), worst_run, n_over


# ---------------------------------------------------------------------------
# the LM serving path (zamba2-7b): flash_attention and ssd_scan
# ---------------------------------------------------------------------------

def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    """Fails unless ``got`` is finite and within atol + rtol * |want| of
    ``want`` everywhere; returns the max abs error."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise Failed(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise Failed(f"{what}: non-finite values")
    err = (got - want).abs()
    n_bad = int((err > atol + rtol * want.abs()).sum())
    if n_bad:
        raise Failed(f"{what}: {n_bad} entries beyond atol {atol} rtol {rtol} "
                     f"(max abs {float(err.max()):.3e})")
    return float(err.max())


def kernel_name(mangled: str) -> str:
    """The kernel's own name and template arguments in a mangled symbol,
    e.g. ``flash_mma_kernel<112>``: the last length-prefixed identifier
    that names a kernel and ends where a name does (template arguments,
    the end of the nested name or the parameters follow)."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            n, start = int(m.group()[i:]), m.end()
            ident, rest = mangled[start:start + n], mangled[start + n:]
            if len(ident) == n and "kernel" in ident and \
                    re.fullmatch(r"[A-Za-z_]\w*", ident) and \
                    not re.match(r"[a-z0-9_]", rest):
                found = (ident, rest)
    if found is None:
        return mangled[:60]
    ident, rest = found
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    if args:
        ident += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return ident


def ptxas_functions(text: str) -> list:
    """One dict per entry function of ``ptxas -v`` output: its name,
    registers, spill stores and loads (bytes) and static shared memory."""
    out, cur = [], None
    for r in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", r)
        if m:
            cur = {"function": kernel_name(m.group(1)), "spill_stores": 0,
                   "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", r)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", r)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", r)
            cur["static_smem"] = int(smem.group(1)) if smem else 0
            out.append(cur)
            cur = None
    return out


def print_occupancy(fa, ssd, head_dim: int, p: int, n: int, chunk: int) -> None:
    """Blocks per SM of each LM kernel at the prefill's shapes, in both
    dtypes, as CUDA's occupancy calculator derives them from the compiled
    registers and the dynamic shared memory (there is no ncu on the card)."""
    import ctypes
    from repro_torch.kernels import _build

    ptr = ctypes.POINTER(ctypes.c_int)
    for dtype, kind in ((1, "bfloat16"), (0, "float32")):
        rows = []
        for module, fn_name, shape, names in (
                (fa, "flash_attention_occupancy", (head_dim,),
                 [f"flash_mma_kernel<{head_dim}>" if dtype
                  else f"flash_kernel<{head_dim}>"]),
                (ssd, "ssd_scan_occupancy", (p, n, chunk),
                 [f"ssd_kernel_chunk_state<{p},{n}>", "ssd_kernel_state_pass",
                  f"ssd_kernel_chunk_scan<{p},{n}>"] if dtype
                 else [f"ssd_kernel<{p},{n}>"])):
            lib = _build.load_library(*module.LIBRARY)
            fn = getattr(lib, fn_name)
            fn.argtypes = [ctypes.c_int] * (len(shape) + 1) + [ptr] * 3
            blocks, threads, smem = ((ctypes.c_int * 3)() for _ in range(3))
            _build.check_launch(lib, module.LIBRARY[0],
                                fn(*shape, dtype, blocks, threads, smem))
            rows += [(name, blocks[i], threads[i], smem[i])
                     for i, name in enumerate(names)]
        for name, b, t, sm in rows:
            line("occupancy", kernel=name, dtype=kind, threads=t,
                 dynamic_smem_bytes=sm, blocks_per_sm=b, warps_per_sm=b * t // 32)


def print_renewal_occupancy(rs, launches: dict) -> None:
    """Blocks per SM of the renewal kernel for each survivor count N and
    lanes per run (1, or one per survivor), and for the path's launches
    (``launches``: label -> (lanes, runs, survivors)) the mapping the
    kernel picks and the blocks and waves it makes on this card."""
    import ctypes
    from repro_torch.kernels import _build

    lib = _build.load_library(*rs.LIBRARY)
    occ_fn = lib.renewal_scan_occupancy
    occ_fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    pick = lib.renewal_scan_lanes_per_run
    pick.argtypes = [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    for n in range(1, rs.MAX_N + 1):
        for per_run in sorted({1, n}):
            blocks, threads, runs = (ctypes.c_int() for _ in range(3))
            _build.check_launch(lib, "renewal_scan",
                                occ_fn(n, per_run, blocks, threads, runs))
            occ[n, per_run] = (blocks.value, threads.value, runs.value)
            line("occupancy", kernel=f"renewal_scan_kernel<{n},{per_run}>",
                 threads=threads.value, runs_per_block=runs.value,
                 blocks_per_sm=blocks.value,
                 warps_per_sm=blocks.value * threads.value // 32)
    for label, (lanes, n_runs, n) in launches.items():
        per_run = pick(n, lanes, n_runs)
        per_sm, threads, runs = occ[n, per_run]
        grid = lanes * -(-n_runs // runs)
        line("occupancy", launch=label,
             kernel=f"renewal_scan_kernel<{n},{per_run}>", lanes_per_run=per_run,
             blocks=grid, sms=sms, waves=f"{grid / (per_sm * sms):.3f}",
             warps_per_sm_first_wave=f"{min(grid / sms, per_sm) * threads / 32:.2f}")


def renewal_bound(args, out: dict, n_surv: int) -> tuple:
    """(bound_ms, bound_by, bytes, occurring decisions) of one renewal
    launch: each operand read once and each output written once at the
    card's memory rate, against FLOP_PER_DECISION per occurring (epoch,
    survivor) decision of this run's data at the float32 rate."""
    n_bytes = sum(t.numel() * t.element_size() for t in args
                  if isinstance(t, torch.Tensor)) \
        + sum(t.numel() * t.element_size() for t in out.values())
    occurring = int(out["valid"].sum()) * n_surv
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = occurring * FLOP_PER_DECISION / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, occurring)


def with_shape(ops, n: int, nf: int):
    """Packed operands at ``n`` survivors and ``nf`` ladder levels: node
    columns taken in turn (a fourth survivor repeats the first), ladder
    levels sliced from level 0."""
    params, nodes, ladder = ops
    cols = [i % nodes.shape[2] for i in range(n)]
    return (params, nodes[:, :, cols].contiguous(),
            ladder[:, :, :nf].contiguous())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def peak_flop_per_s(dtype) -> float:
    return PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_FP32_FLOP_PER_S


def bound(n_bytes: int, flops: float, dtype) -> tuple:
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flop_per_s(dtype) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def flash_work(q, k, window) -> float:
    """flop of causal attention on these shapes: 4 d per (query, key) pair
    that the mask keeps (q.k and p.v), queries the suffix of the keys."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    keys = np.arange(sq) + (sk - sq) + 1
    if window is not None:
        keys = np.minimum(keys, window)
    return 4.0 * d * bh * float(keys.sum())


def ssd_work(x, bmat, chunk: int) -> float:
    """flop of the chunked scan: per chunk the causal half of C.B^T and of
    its product with dax, the inter-chunk term and the state update."""
    b, h, s, p = x.shape
    n, q = bmat.shape[3], chunk
    return float(b * h * (s // q)) * (q * (q + 1) * (n + p) + 4.0 * q * n * p)


def flash_vs_plain(fa, label, q, k, v, group, window) -> float:
    got = fa.flash_attention_bhsd(q, k, v, group=group, window=window)
    want = fa.flash_attention_reference(q, k, v, group=group, window=window)
    torch.cuda.synchronize()
    err = check_close(f"flash {label}", got, want, *fa.PLAIN_TOL[q.dtype])
    line("lm-kernel-vs-plain", kernel="flash_attention", case=label,
         shape=tuple(q.shape), kv=tuple(k.shape), group=group, window=window,
         dtype=str(q.dtype).replace("torch.", ""), max_abs_err=f"{err:.3e}")
    return err


def ssd_vs_plain(ssd, label, x, dt, a, bm, cm, chunk) -> float:
    y, st = ssd.ssd_scan_bhsp(x, dt, a, bm, cm, chunk=chunk)
    y_p, st_p = ssd.ssd_scan_reference(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    err = max(check_close(f"ssd {label} y", y, y_p, *TOL_SSD),
              check_close(f"ssd {label} state", st, st_p, *TOL_SSD))
    line("lm-kernel-vs-plain", kernel="ssd_scan", case=label,
         x=tuple(x.shape), bc=tuple(bm.shape), chunk=chunk,
         dtype=str(x.dtype).replace("torch.", ""), max_abs_err=f"{err:.3e}")
    return err


def flash_operands(bh_b, h, kh, s, d, dtype, seed, dev, sk=None):
    """q (bh_b*h, s, d) pre-scaled, k and v (bh_b*kh, sk or s, d)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sk = s if sk is None else sk
    q = torch.randn((bh_b * h, s, d), generator=gen, device=dev) * d ** -0.5
    k = torch.randn((bh_b * kh, sk, d), generator=gen, device=dev)
    v = torch.randn((bh_b * kh, sk, d), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def ssd_operands(b, h, g, s, p, n, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, s, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, h, 1, s), generator=gen, device=dev))
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.2)
    bm = (torch.randn((b, g, s, n), generator=gen, device=dev) * 0.3).to(dtype)
    cm = (torch.randn((b, g, s, n), generator=gen, device=dev) * 0.3).to(dtype)
    return x, dt, a, bm, cm


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (host clock,
    synchronised), the device time of its kernels by class, the device busy
    share (kernel time over wall time; kernels on one stream do not
    overlap) and the eight longest kernels.  Returns None for the times if
    the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes = {"flash_attention": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
               "other": 0.0}
    # the SSD scan's kernels: three per bf16 call, one per float32 call
    ssd_parts = {part: 0.0 for part in SSD_PARTS}
    kernels, n_launch = [], 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        n_launch += ev.count
        kernels.append((ms, ev.key[:60], ev.count))
        name = ev.key.lower()
        if "flash_kernel" in name or "flash_mma_kernel" in name:
            classes["flash_attention"] += ms
        elif "ssd_kernel" in name:
            classes["ssd_scan"] += ms
            part = next((p for p in SSD_PARTS if f"ssd_kernel_{p}" in name),
                        "float32")
            ssd_parts[part] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    device_ms = sum(classes.values())
    if device_ms == 0.0:
        return {"wall_ms": wall_ms, "device_ms": None}
    return {"wall_ms": wall_ms, "device_ms": device_ms, "launches": n_launch,
            "busy_share": device_ms / wall_ms, "classes": classes,
            "ssd_parts": ssd_parts, "top": sorted(kernels, reverse=True)[:8]}


def print_profile(phase: str, card_line: str, prof: dict) -> None:
    if prof["device_ms"] is None:
        line(phase, card=repr(card_line), wall_ms=f"{prof['wall_ms']:.3f}",
             device_time="not measured (the trace holds no device time)")
        return
    line(phase, card=repr(card_line), wall_ms=f"{prof['wall_ms']:.3f}",
         device_ms=f"{prof['device_ms']:.3f}", kernel_launches=prof["launches"],
         busy_share=f"{prof['busy_share']:.4f}",
         **{f"{k}_ms": f"{v:.3f}" for k, v in prof["classes"].items()},
         **{f"ssd_{k}_ms": f"{v:.3f}" for k, v in prof["ssd_parts"].items()})
    for ms, name, count in prof["top"]:
        line(phase, kernel=repr(name), count=count, device_ms=f"{ms:.3f}")


def lm_path(card_line: str, fa, ssd) -> list:
    """Phases 6-10: the Zamba2-7B serving path.  Returns the kernel
    records of flash_attention and ssd_scan."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, transformer

    torch.backends.cuda.matmul.allow_tf32 = False      # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH, use_flash_kernel=True)
    hd, heads = cfg.d_model // cfg.hybrid.shared_num_heads, cfg.hybrid.shared_num_heads
    s_cfg = cfg.ssm
    ssm_heads = s_cfg.expand * cfg.d_model // s_cfg.head_dim
    worst = {"flash_attention": 0.0, "ssd_scan": 0.0}

    print_occupancy(fa, ssd, hd, s_cfg.head_dim, s_cfg.state_dim, s_cfg.chunk_size)

    # --- phase 6: kernels against their plain versions on the card ---------
    # (label, batch, heads, kv heads, Sq, head dim, dtype, window, Sk)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("zamba2-prefill", PREFILL_BATCH, heads, heads, PREFILL_LEN, hd,
              bf16, None, None),
             ("ragged-4000", PREFILL_BATCH, heads, heads, 4000, hd, bf16,
              None, None),
             ("gqa-window", 2, 4, 1, 256, 64, f32, 128, None),
             ("gqa-window-bf16", 2, 4, 1, 256, 64, bf16, 128, None),
             ("gqa-window-nonpow2", 1, 6, 2, 384, 64, f32, 256, None),
             ("suffix-200-of-1000-bf16", 1, 4, 2, 200, 64, bf16, None, 1000),
             ("float32-d128", 1, 8, 2, 1000, 128, f32, None, None),
             ("bf16-d16", 1, 4, 2, 512, 16, bf16, None, None),
             ("bf16-d256", 1, 4, 2, 512, 256, bf16, None, None)]
    for i, (label, b, h, kh, s, d, dtype, win, sk) in enumerate(cases):
        q, k, v = flash_operands(b, h, kh, s, d, dtype, 100 + i, dev, sk)
        worst["flash_attention"] = max(worst["flash_attention"],
                                       flash_vs_plain(fa, label, q, k, v,
                                                      h // kh, win))
    # (label, dtype, batch, heads, groups, S, chunk); zamba2-prefill takes
    # 16 chunks through the state-passing kernel, chunk-13 is a 13-token
    # prompt (ops.ssd_scan takes min(chunk, S))
    q_cfg = s_cfg.chunk_size
    for i, (label, dtype, b, h, g, s, chunk) in enumerate((
            ("zamba2-prefill", bf16, PREFILL_BATCH, ssm_heads, 1, PREFILL_LEN, q_cfg),
            ("zamba2-float32", f32, PREFILL_BATCH, ssm_heads, 1, PREFILL_LEN, q_cfg),
            ("groups-4", bf16, PREFILL_BATCH, 8, 4, 1024, q_cfg),
            ("chunk-13", bf16, 1, 8, 1, 13, 13),
            ("chunk-48", bf16, PREFILL_BATCH, 8, 1, 96, 48))):
        ops_ = ssd_operands(b, h, g, s, s_cfg.head_dim, s_cfg.state_dim, dtype,
                            200 + i, dev)
        worst["ssd_scan"] = max(worst["ssd_scan"], ssd_vs_plain(
            ssd, label, *ops_, chunk))
    del q, k, v, ops_
    torch.cuda.empty_cache()

    # --- phase 7: bf16 prefill at full width, 2 x 4096 ---------------------
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)), device=dev)
    prefill = make_prefill_step(model)
    batch = {"tokens": tokens}
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    first_only = lambda i, *call: call if i == 0 else None
    with recorded(ops, "flash_attention_bhsd", first_only) as cap_fa, \
            recorded(ops, "ssd_scan_bhsp", first_only) as cap_ssd:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_scan": ssd.LAUNCHES["ssd_scan"]}
    n_super = cfg.num_layers // cfg.hybrid.shared_every
    expect = {"flash_attention": n_super, "ssd_scan": cfg.num_layers}
    if launches != expect:
        raise Failed(f"prefill launched {launches}, expected {expect}")
    if (len(cap_fa), len(cap_ssd)) != (n_super, cfg.num_layers):
        raise Failed("kernel calls and launches disagree")
    if last.shape != (PREFILL_BATCH, cfg.padded_vocab_size) or \
            not torch.isfinite(last).all():
        raise Failed(f"prefill logits: shape {tuple(last.shape)} or non-finite")
    line("prefill", arch=LM_ARCH, dtype="bfloat16", params=n_params,
         init_s=f"{init_s:.2f}", batch=PREFILL_BATCH, tokens=PREFILL_LEN,
         launches=json.dumps(launches), logits_absmax=f"{float(last.abs().max()):.4f}")
    del last

    # the operands of the first launch of each kernel against the plain version
    fa_args, fa_kw, fa_out = cap_fa[0]
    ssd_args, ssd_kw, (ssd_y, ssd_st) = cap_ssd[0]
    fa_plain = fa.flash_attention_reference(*fa_args, **fa_kw)
    err_fa = check_close("flash first prefill launch", fa_out, fa_plain,
                         *fa.PLAIN_TOL[fa_out.dtype])
    y_p, st_p = ssd.ssd_scan_reference(*ssd_args, **ssd_kw)
    err_ssd = max(check_close("ssd first prefill launch y", ssd_y, y_p, *TOL_SSD),
                  check_close("ssd first prefill launch state", ssd_st, st_p,
                              *TOL_SSD))
    worst["flash_attention"] = max(worst["flash_attention"], err_fa)
    worst["ssd_scan"] = max(worst["ssd_scan"], err_ssd)
    del fa_plain, y_p, st_p
    line("prefill-first-launch", flash_max_abs_err=f"{err_fa:.3e}",
         flash_operands=tuple(fa_args[0].shape), ssd_max_abs_err=f"{err_ssd:.3e}",
         ssd_operands=tuple(ssd_args[0].shape))

    # times: the prefill whole, each kernel alone, its plain version, SDPA
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls[1:])
    q, k, v = fa_args
    group, window = fa_kw["group"], fa_kw.get("window")
    fa_ms, fa_host = kernel_only_ms(
        lambda: fa.flash_attention_bhsd(*fa_args, **fa_kw), LM_KERNEL_REPS)
    fa_plain_ms = statistics.median(cuda_ms(
        lambda: fa.flash_attention_reference(*fa_args, **fa_kw), reps=3, warmup=1))
    b_kv = q.shape[0] // heads
    q4 = q.view(b_kv, heads, q.shape[1], q.shape[2])
    k4 = k.view(b_kv, k.shape[0] // b_kv, k.shape[1], k.shape[2])
    v4 = v.view(b_kv, v.shape[0] // b_kv, v.shape[1], v.shape[2])
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=1.0, enable_gqa=True)
    sdpa_err = float((sdpa().reshape(fa_out.shape).float()
                      - fa_out.float()).abs().max())
    sdpa_ms, _ = kernel_only_ms(sdpa, LM_KERNEL_REPS)
    fa_bound, fa_by = bound(nbytes(q, k, v, fa_out), flash_work(q, k, window),
                            q.dtype)
    ssd_chunk = ssd_kw["chunk"]
    ssd_ms, ssd_host = kernel_only_ms(
        lambda: ssd.ssd_scan_bhsp(*ssd_args, **ssd_kw), LM_KERNEL_REPS)
    ssd_plain_ms = statistics.median(cuda_ms(
        lambda: ssd.ssd_scan_reference(*ssd_args, **ssd_kw), reps=3, warmup=1))
    ssd_bound, ssd_by = bound(nbytes(*ssd_args, ssd_y, ssd_st),
                              ssd_work(ssd_args[0], ssd_args[3], ssd_chunk),
                              ssd_args[0].dtype)
    line("timing", kernel="flash_attention", card=repr(card_line),
         kernel_ms=f"{fa_ms:.5f}", wrapper_host_ms=f"{fa_host:.5f}",
         plain_ms_median=f"{fa_plain_ms:.3f}", sdpa_ms=f"{sdpa_ms:.5f}",
         sdpa_vs_kernel_max_abs=f"{sdpa_err:.3e}", bound_ms=f"{fa_bound:.5f}",
         bound_by=fa_by, flop=f"{flash_work(q, k, window):.4e}",
         bytes=nbytes(q, k, v, fa_out))
    line("timing", kernel="ssd_scan", card=repr(card_line),
         kernel_ms=f"{ssd_ms:.5f}", wrapper_host_ms=f"{ssd_host:.5f}",
         plain_ms_median=f"{ssd_plain_ms:.3f}", bound_ms=f"{ssd_bound:.5f}",
         bound_by=ssd_by, flop=f"{ssd_work(ssd_args[0], ssd_args[3], ssd_chunk):.4e}",
         bytes=nbytes(*ssd_args, ssd_y, ssd_st))
    line("clocks", during="flash_attention x100", card=repr(card_line),
         sm_clock_max_clock_power_temperature=repr(loaded_clocks(
             lambda: fa.flash_attention_bhsd(*fa_args, **fa_kw), 100)))
    kernels_ms = n_super * fa_ms + cfg.num_layers * ssd_ms
    line("prefill-breakdown", arch=LM_ARCH, card=repr(card_line),
         wall_ms_median=f"{wall_ms:.3f}", walls_ms=[f"{w:.3f}" for w in walls],
         flash_ms_x13=f"{n_super * fa_ms:.3f}",
         ssd_ms_x81=f"{cfg.num_layers * ssd_ms:.3f}",
         rest_ms=f"{wall_ms - kernels_ms:.3f}",
         tokens_per_s=f"{PREFILL_BATCH * PREFILL_LEN / (wall_ms * 1e-3):.1f}")
    del cap_fa, cap_ssd, fa_args, ssd_args, fa_out, ssd_y, ssd_st, q, k, v
    del q4, k4, v4
    print_profile("prefill-profile", card_line,
                  device_profile(lambda: prefill(params, batch)))

    # --- phase 9 (run here, on the bf16 weights): the serve loop -----------
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    res = serve.serve(model, params, prompts, SERVE_GEN)
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or toks.min() < 0 or \
            toks.max() >= cfg.padded_vocab_size:
        raise Failed(f"serve loop tokens: shape {toks.shape}, range "
                     f"[{toks.min()}, {toks.max()}]")
    line("serve-loop", arch=LM_ARCH, dtype="bfloat16", card=repr(card_line),
         batch=SERVE_BATCH, bucket=res["bucket"], prompt=SERVE_PROMPT,
         gen=SERVE_GEN, tokens_per_s=f"{res['tokens_per_s']:.2f}",
         kernel_launches=fa.LAUNCHES["flash_attention"] + ssd.LAUNCHES["ssd_scan"],
         first_row=toks[0, :8].tolist())
    step = make_serve_step(model)
    cache = model.init_cache(SERVE_BATCH, 8)
    tok = torch.as_tensor(prompts[:, :1], dtype=torch.int32, device=dev)
    step(params, cache, tok, 0)

    def three_steps():
        for t in range(1, 4):
            step(params, cache, tok, t)
    prof = device_profile(three_steps)
    print_profile("decode-profile", card_line, prof)
    del cache
    del model, params, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()

    # --- phase 8: float32 prefill against decode and the plain path --------
    cfg32 = get_config(LM_ARCH, use_flash_kernel=True, dtype="float32")
    model = build_model(cfg32, device="cuda")
    params = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, DECODE_CHECK_LEN)), device=dev)
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    # the hidden state after each Mamba2 layer, at the last position
    last_pos = lambda i, args, kw, x: x[:, -1].float().clone()
    with recorded(transformer, "_ssm_block", last_pos) as pre_layers:
        last = make_prefill_step(model)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"]) != \
            (n_super, cfg.num_layers):
        raise Failed("the float32 prefill did not launch both kernels per layer")
    plain = build_model(dataclasses.replace(cfg32, use_flash_kernel=False), "cuda")
    last_plain = make_prefill_step(plain)(params, {"tokens": tokens})
    err_plain = check_close("float32 prefill kernel path vs plain path", last,
                            last_plain, *TOL_SSD)
    step = make_serve_step(model)
    cache = model.init_cache(PREFILL_BATCH, DECODE_CHECK_LEN)
    t0 = time.perf_counter()
    for t in range(DECODE_CHECK_LEN - 1):
        _, cache = step(params, cache, tokens[:, t:t + 1], t)
    with torch.inference_mode(), recorded(
            transformer, "_ssm_block_decode",
            lambda i, args, kw, x: x[:, 0].float().clone()) as dec_layers:
        dec_logits, _ = model.decode_step(params, cache, tokens[:, -1:],
                                          DECODE_CHECK_LEN - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_last = dec_logits[:, -1]
    # relative error of the hidden state after each super-block (its last
    # Mamba2 layer) and after the tail, prefill against decode
    every = cfg.hybrid.shared_every
    marks = [every * i + every - 1 for i in range(n_super)] + [cfg.num_layers - 1]
    per_block = [float((pre_layers[i] - dec_layers[i]).abs().max()
                       / pre_layers[i].abs().max()) for i in marks]
    argmax_equal = bool(torch.equal(last.argmax(-1), dec_last.argmax(-1)))
    err = (dec_last.double() - last.double()).abs()
    line("prefill-vs-decode", arch=LM_ARCH, dtype="float32",
         tokens=DECODE_CHECK_LEN, batch=PREFILL_BATCH,
         max_abs_err=f"{float(err.max()):.3e}",
         logits_absmax=f"{float(last.abs().max()):.4f}",
         argmax_equal=argmax_equal, decode_s=f"{decode_s:.2f}",
         kernel_vs_plain_max_abs=f"{err_plain:.3e}",
         per_superblock_rel=[f"{e:.2e}" for e in per_block])
    check_close("float32 decode vs prefill logits", dec_last, last, *TOL_DECODE)
    if not argmax_equal:
        raise Failed("float32 decode and prefill disagree on the argmax")
    del model, plain, params, cache, last, last_plain, dec_logits
    gc.collect()
    torch.cuda.empty_cache()

    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:89",
         "launches": launches["flash_attention"],
         "max_abs_err": worst["flash_attention"], "ms": fa_ms,
         "plain_ms": fa_plain_ms, "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": sdpa_ms},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:75",
         "launches": launches["ssd_scan"],
         "max_abs_err": worst["ssd_scan"], "ms": ssd_ms,
         "plain_ms": ssd_plain_ms, "bound_ms": ssd_bound, "bound_by": ssd_by,
         "library_ms": None},
    ]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import failures, optimize, prng, sweep
    from repro_torch.core.scenarios import (apply_policy, paper_scenarios,
                                            sparse_rendezvous_scenario)
    from repro_torch.kernels import _build
    from repro_torch.kernels import renewal_scan as rs

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card_line = card()

    # --- phase 1: build all kernels, one nvcc each, started together -------
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    t_build = time.perf_counter()
    _build.load_libraries([rs.LIBRARY, fa.LIBRARY, ssd.LIBRARY])
    line("build", kernels=3, wall_seconds=f"{time.perf_counter() - t_build:.2f}",
         card=repr(card_line))
    for name, _, flags in (rs.LIBRARY, fa.LIBRARY, ssd.LIBRARY):
        info = _build.build_log[name]
        line("build", kernel=name, seconds=f"{info['seconds']:.2f}",
             cached=info["cached"], fmad=("-fmad=false" not in flags))
        for fn in ptxas_functions(info["ptxas"]):
            line("build", kernel=name, **fn)

    scen = list(paper_scenarios().values())
    grid_cfg = sparse_rendezvous_scenario()
    table = optimize.policy_grid(
        ckpt_interval=np.geomspace(2400.0, 19200.0, 7), mu1=[3.8, 6.0, 9.0],
        wait_mode=[0, 1])
    makespans = optimize.wall_makespan(GRID_WORK_S, table.ckpt_interval,
                                       grid_cfg.ckpt_duration)
    _, scen_stack = sweep._renewal_device_inputs(scen, torch.float32, dev)
    scen_ops = sweep._pack_kernel_inputs(scen_stack, MAKESPAN_S)
    grid_ops = sweep._pack_kernel_inputs(
        optimize.policy_inputs(grid_cfg, table, dev), makespans)
    n_surv = scen_ops[1].shape[2]
    print_renewal_occupancy(rs, {
        "main-path": (len(scen), FULL_RUNS, n_surv),
        "policy-grid": (len(table), FULL_RUNS, n_surv),
        "weibull": (len(scen), WEIBULL_RUNS, n_surv)})

    # --- phase 2: kernel against its plain version, R not a multiple of 128
    r2, k2, n_nodes = 1000, FULL_EPOCHS, len(scen[0].survivors) + 1
    worst_abs = worst_rel = 0.0
    for label, ops, mtbf in (("scenarios", scen_ops, MTBF_S),
                             ("policies", grid_ops, GRID_MTBF_S)):
        g32, _ = failures.sample_renewal_gaps(
            failures.Exponential(mtbf), prng.PRNGKey(7), r2, k2, n_nodes, dev)
        gaps_t = g32.T.contiguous()
        gen = torch.Generator(device="cpu").manual_seed(11)
        felled = (torch.rand((k2, n_nodes - 1, r2), generator=gen) < 0.15
                  ).float().to(dev)
        for fel, comp in ((None, True), (felled, True), (None, False)):
            got = rs.renewal_scan(*ops, gaps_t, fel, compensated=comp)
            want = rs.renewal_scan_reference(*ops, gaps_t, fel,
                                             compensated=comp)
            torch.cuda.synchronize()
            max_abs, max_rel = compare_outputs(got, want)
            worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
            line("kernel-vs-plain", lanes=f"{label}:{ops[0].shape[0]}",
                 runs=r2, epochs=k2, felled=fel is not None,
                 compensated=comp, ints="exact",
                 max_abs_err=f"{max_abs:.6g}", max_rel_err=f"{max_rel:.3e}")

    # --- phase 2b: every survivor count and ladder depth the kernel takes,
    # warps and blocks part-filled (R = 1, 31) and whole, both mappings of
    # runs to lanes; (felled, compensated) alternate over the shapes so each
    # shape sees two of the four and each (N, F) all four
    variants = ((False, True), (True, False), (True, True), (False, False))
    for n in range(1, rs.MAX_N + 1):
        for nf in range(1, rs.MAX_F + 1):
            ops = with_shape(scen_ops, n, nf)
            seen, n_cases, shape_abs = set(), 0, 0.0
            for j, (k, r) in enumerate(SHAPE_KR):
                g32, _ = failures.sample_renewal_gaps(
                    failures.Exponential(MTBF_S), prng.PRNGKey(100 + j), r, k,
                    n + 1, dev)
                gaps_t = g32.T.contiguous()
                gen = torch.Generator(device="cpu").manual_seed(17 + j)
                felled = (torch.rand((k, n, r), generator=gen) < 0.15
                          ).float().to(dev)
                for use_fel, comp in (variants[(j + n + nf) % 4],
                                      variants[(j + n + nf + 2) % 4]):
                    fel = felled if use_fel else None
                    want = rs.renewal_scan_reference(*ops, gaps_t, fel,
                                                     compensated=comp)
                    # the kernel's own pick of lanes per run, then each
                    # mapping forced
                    for lanes in (None,) + tuple(sorted({1, n})):
                        got = rs._launch_cuda(*ops, gaps_t, fel, comp,
                                              lanes=lanes)
                        torch.cuda.synchronize()
                        max_abs, max_rel = compare_outputs(got, want)
                        shape_abs = max(shape_abs, max_abs)
                        worst_abs = max(worst_abs, max_abs)
                        worst_rel = max(worst_rel, max_rel)
                    seen.add((use_fel, comp))
                    n_cases += 1
            if len(seen) != 4:
                raise Failed(f"kernel-shapes n={n} nf={nf}: only {sorted(seen)}")
            line("kernel-shapes", survivors=n, levels=nf, lanes=ops[0].shape[0],
                 shapes="K,R=" + "/".join(f"{k}x{r}" for k, r in SHAPE_KR),
                 cases=n_cases, felled_compensated="all four",
                 lanes_per_run="auto/" + "/".join(map(str, sorted({1, n}))),
                 ints="exact",
                 max_abs_err=f"{shape_abs:.6g}")

    # --- phase 3: the main path at the size users run ----------------------
    key = prng.PRNGKey(1)
    summaries, main_launches, (main_call,) = drive(
        rs, lambda: sweep.renewal_monte_carlo_scenarios(
            scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
            engine="kernel"))
    scen_args, scen_kw, ker_out = main_call
    max_abs, max_rel = compare_outputs(
        ker_out, rs.renewal_scan_reference(*scen_args, **scen_kw))
    worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
    line("main-path", call="renewal_monte_carlo_scenarios",
         scenarios=len(scen), runs=FULL_RUNS, epochs=FULL_EPOCHS,
         launches=main_launches, kernel_vs_plain="ints exact",
         max_abs_err=f"{max_abs:.6g}", max_rel_err=f"{max_rel:.3e}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, FULL_RUNS, n_nodes, FULL_EPOCHS, MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    row = lambda st, s: {f: st[f][s] for f in
                         ("energy_ref", "energy_int", "balanced_energy",
                          "end_time", "saving", "n_failures")}
    for s, cfg in enumerate(scen):
        err, _, _ = check_against_oracle("main-path", sweep, cfg,
                                         row(ker_out, s), gaps_o, failed_o,
                                         MAKESPAN_S)
        sm = summaries[cfg.name]
        check_summary(cfg.name, sm, ker_out, s)
        line("main-path", scenario=cfg.name,
             mean_failures=f"{sm.mean_failures:.6f}",
             mean_saving_pct=f"{sm.mean_saving_pct:.6f}",
             sleep_occupancy=f"{sm.sleep_occupancy:.6f}",
             oracle_rel_err=f"{err:.3e}")

    # kernel time at the main path's own operands, and its plain version's
    launch_main = lambda: rs.renewal_scan(*scen_args, **scen_kw)
    k_ms, host_ms = kernel_only_ms(launch_main, n=KERNEL_REPS)
    call_ms = statistics.median(cuda_ms(launch_main, reps=KERNEL_REPS))
    p_ms = statistics.median(cuda_ms(
        lambda: rs.renewal_scan_reference(*scen_args, **scen_kw),
        reps=3, warmup=1))
    slots = len(scen) * FULL_RUNS * FULL_EPOCHS * (n_nodes - 1)
    bound_ms, bound_by, n_bytes, occurring = renewal_bound(
        scen_args, ker_out, n_nodes - 1)
    line("timing", kernel="renewal_scan", card=repr(card_line),
         kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
         call_ms_median=f"{call_ms:.5f}", plain_ms_median=f"{p_ms:.2f}",
         slots=slots, slot_decisions_per_s=f"{slots / (k_ms * 1e-3):.4e}",
         occurring_decisions=occurring,
         occurring_decisions_per_s=f"{occurring / (k_ms * 1e-3):.4e}",
         bytes=n_bytes, bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
         bound_share=f"{bound_ms / k_ms:.4f}")

    # where the entry point's time goes: host clock around whole calls,
    # CUDA events around the device stages
    def wall_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    entry_ms = wall_ms(lambda: sweep.renewal_monte_carlo_scenarios(
        scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
        engine="kernel"), reps=5)
    sample_ms = statistics.median(cuda_ms(lambda: failures.sample_renewal_gaps(
        failures.Exponential(MTBF_S), key, FULL_RUNS, FULL_EPOCHS, n_nodes,
        dev), reps=5))
    pack_ms = wall_ms(lambda: sweep._pack_kernel_inputs(
        sweep._renewal_device_inputs(scen, torch.float32, dev)[1],
        MAKESPAN_S), reps=5)
    line("breakdown", call="renewal_monte_carlo_scenarios",
         card=repr(card_line), wall_ms_median=f"{entry_ms:.3f}",
         sample_ms=f"{sample_ms:.3f}", stack_and_pack_ms=f"{pack_ms:.3f}",
         kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
         wall_decisions_per_s=f"{slots / (entry_ms * 1e-3):.4e}")

    # --- phase 4: the 42-policy grid ---------------------------------------
    res, grid_launches, (grid_call,) = drive(
        rs, lambda: optimize.evaluate_policy_grid(
            grid_cfg, table, key, work_s=GRID_WORK_S, n_runs=FULL_RUNS,
            max_failures=FULL_EPOCHS, mtbf_s=GRID_MTBF_S, engine="kernel"))
    grid_args, grid_kw, grid_out = grid_call
    g_abs, g_rel = compare_outputs(
        grid_out, rs.renewal_scan_reference(*grid_args, **grid_kw))
    worst_abs, worst_rel = max(worst_abs, g_abs), max(worst_rel, g_rel)
    if not np.all(np.isfinite(res.mean_energy_j)):
        raise Failed("policy grid: non-finite energies")
    best = res.best
    knee = optimize.knee_point(res.mean_energy_j, res.mean_makespan_s)
    grid_wall_ms = wall_ms(lambda: optimize.evaluate_policy_grid(
        grid_cfg, table, key, work_s=GRID_WORK_S, n_runs=FULL_RUNS,
        max_failures=FULL_EPOCHS, mtbf_s=GRID_MTBF_S, engine="kernel"), reps=3)
    launch_grid = lambda: rs.renewal_scan(*grid_args, **grid_kw)
    grid_k_ms, grid_host_ms = kernel_only_ms(launch_grid, n=KERNEL_REPS)
    g_bound, g_by, g_bytes, g_occ = renewal_bound(grid_args, grid_out,
                                                  n_nodes - 1)
    line("policy-grid-timing", card=repr(card_line),
         wall_ms_median=f"{grid_wall_ms:.3f}", kernel_ms=f"{grid_k_ms:.5f}",
         wrapper_host_ms=f"{grid_host_ms:.5f}",
         lanes=len(table), runs=FULL_RUNS, epochs=FULL_EPOCHS,
         occurring_decisions=g_occ, bytes=g_bytes, bound_ms=f"{g_bound:.5f}",
         bound_by=g_by, bound_share=f"{g_bound / grid_k_ms:.4f}")
    line("clocks", during="renewal_scan policy grid x2000",
         card=repr(card_line), sm_clock_max_clock_power_temperature=repr(
             loaded_clocks(launch_grid, 2000)))
    line("policy-grid", policies=len(table), runs=FULL_RUNS,
         epochs=FULL_EPOCHS, launches=grid_launches,
         kernel_vs_plain="ints exact", max_abs_err=f"{g_abs:.6g}",
         max_rel_err=f"{g_rel:.3e}", argmin=best,
         argmin_policy=repr(table.policy(best)), knee=knee,
         knee_policy=repr(table.policy(knee)),
         argmin_mean_energy_j=f"{res.mean_energy_j[best]:.6e}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, FULL_RUNS, n_nodes, FULL_EPOCHS, GRID_MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    for p in sorted({0, best, len(table) - 1}):
        # the oracle gets the interval the kernel sees (its float32 value):
        # the model jumps by a rendezvous period at an exact wrap, so a
        # 1e-12 s difference in the interval can move a whole run
        pol = dict(table.policy(p),
                   ckpt_interval=float(np.float32(table.ckpt_interval[p])))
        cfg_p = apply_policy(grid_cfg, **pol)
        stats_row = {f: torch.as_tensor(getattr(res, f)[p]) for f in
                     ("energy_ref", "energy_int", "saving", "end_time",
                      "n_failures")}
        err, worst_run, n_over = check_against_oracle(
            "policy-grid", sweep, cfg_p, stats_row, gaps_o, failed_o,
            float(makespans[p]), per_run=False)
        line("policy-grid", policy=p, mean_oracle_rel_err=f"{err:.3e}",
             worst_run_rel_err=f"{worst_run:.3e}",
             runs_over_tol=f"{n_over}/{ORACLE_RUNS}")

    # --- phase 5: Weibull k=0.7 at equal MTBF -------------------------------
    proc = failures.Weibull.from_mtbf(0.7, MTBF_S)
    wstats, w_launches, (w_call,) = drive(
        rs, lambda: sweep.renewal_monte_carlo_device(
            scen, key, n_runs=WEIBULL_RUNS, max_failures=FULL_EPOCHS,
            process=proc, engine="kernel"))
    w_args, w_kw, w_out = w_call
    w_abs, w_rel = compare_outputs(
        w_out, rs.renewal_scan_reference(*w_args, **w_kw))
    worst_abs, worst_rel = max(worst_abs, w_abs), max(worst_rel, w_rel)
    line("weibull", scenarios=len(scen), runs=WEIBULL_RUNS,
         epochs=FULL_EPOCHS, launches=w_launches,
         kernel_vs_plain="ints exact", max_abs_err=f"{w_abs:.6g}",
         max_rel_err=f"{w_rel:.3e}")
    w_ms, w_host_ms = kernel_only_ms(
        lambda: rs.renewal_scan(*w_args, **w_kw), n=KERNEL_REPS)
    w_bound, w_by, w_bytes, w_occ = renewal_bound(w_args, w_out, n_nodes - 1)
    line("weibull-timing", card=repr(card_line), kernel_ms=f"{w_ms:.5f}",
         wrapper_host_ms=f"{w_host_ms:.5f}", lanes=len(scen),
         runs=WEIBULL_RUNS, epochs=FULL_EPOCHS, occurring_decisions=w_occ,
         bytes=w_bytes, bound_ms=f"{w_bound:.5f}", bound_by=w_by,
         bound_share=f"{w_bound / w_ms:.4f}")
    gaps, failed = sweep.renewal_failure_gaps(
        key, WEIBULL_RUNS, n_nodes, FULL_EPOCHS, process=proc)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    wrow = lambda s: {f.name: getattr(wstats, f.name)[s]
                      for f in dataclasses.fields(wstats)}
    for s, cfg in enumerate(scen):
        err, _, _ = check_against_oracle("weibull", sweep, cfg, wrow(s),
                                         gaps_o, failed_o, MAKESPAN_S)
        line("weibull", scenario=cfg.name,
             mean_failures=f"{float(wstats.n_failures[s].float().mean()):.6f}",
             oracle_rel_err=f"{err:.3e}")

    renewal_record = {
        "name": "renewal_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/renewal_scan.cu",
        "replaces": "src/repro/kernels/renewal_scan.py:322",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    line("renewal-done", seconds=f"{time.perf_counter() - t_start:.1f}",
         worst_kernel_vs_plain_rel=f"{worst_rel:.3e}")

    lm_records = lm_path(card_line, fa, ssd)
    records = [renewal_record] + lm_records
    line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card_line)
    print(json.dumps({"kernels": records}))
    print("kernels: " + json.dumps([r["name"] for r in records]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
