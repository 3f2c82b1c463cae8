"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's six CUDA kernels from the sources in this checkout (one
nvcc each, all started together) and holds each against its plain PyTorch
version on the card.  Then it drives the port's paths at the size users
run them, each with the launch counts set to 0 just before it and read just
after, and holds launches of each path against the plain version on the
same operands:

* the renewal Monte-Carlo over the paper's six Table-4 scenarios, the
  42-policy grid and Weibull failures, checked against the port's float64
  host oracle (``renewal_scan``; before them the kernel is held bit-equal
  to its plain version at 1-4 survivors, 1-4 ladder levels, K 1 and 64,
  R 1, 31 and 1000 in both mappings of runs to lanes: ``[kernel-shapes]``,
  and past those shapes, up to the caps of 64 survivors and 16 levels,
  then the fleet preset's 7 survivors, 9 x 4, 16 x 8, 17 x 5, 32 x 8,
  33 x 4 and 64 x 16 at the main path's size, timed: ``[kernel-bounds]``);
* correlated rack failures at the main path's size under the reference's
  gentle and aggressive topologies, both engines against the float64
  oracle (``[correlated]``), and the failure-process axis (LogNormal,
  Gamma, empirical traces) through both engines (``[processes]``);
* the paper's single-failure path and the float64 scan engine, plain
  PyTorch on the card: Table 4 through ``compare`` against the published
  rows (``[table4]``); ``sweep_scenarios`` over the six scenarios x 262,144
  failure instants x an eight-margin mu-band, against the CPU and the
  event oracle (``[sweep]``); ``monte_carlo`` at 2^20 instants per
  scenario against the CPU (``[monte-carlo]``); the scan engine at the
  main path's size and on the 42-policy grid against the float64 oracle,
  the CPU and the kernel engine (``[renewal-f64]``);
* the operator stack, plain PyTorch on the card but for one kernel launch:
  ``optimize_policy`` on the 42-policy grid at 4096 runs x 64 epochs on
  the scan and the kernel (one launch), CEM at its defaults and the
  equal-MTBF process panel (``[optimize]``); the fleet advisor over 256
  clusters, one bucket and four, against standalone calls and the
  per-cluster loop (``[fleet]``); the ``fleet`` and ``policy_grid``
  campaign presets against direct dispatches, and the ``smoke`` preset cut
  and resumed through the campaign CLI (``[campaign]``);
* the models' constant tables on the card against the CPU's bits
  (``[card-vs-cpu]``: RoPE's inverse frequencies at head_dim 112, the
  1500 x 1024 sinusoids);
* the LM kernels against their plain versions (``[lm-kernel-vs-plain]``):
  flash attention at the path's shapes and edges, the SSD scan at
  zamba2-7b's prefill in both dtypes, four groups, mamba2-370m's
  (P, N) = (64, 128), chunks 13, 48, 100, 192 and 512, and the fused
  chunk state's chain (one (batch, head) of 64 chunks; 3,584 units at
  chunk 100), with the bf16 chunk-state and chunk-scan kernels of each
  (P, N, chunk) held equal to the module's ``BF16_CHUNK_STATE`` and
  ``BF16_CHUNK_SCAN`` (``[ssd-tiles]``) as flash's tiles are
  (``[flash-tiles]``);
* Zamba2-7B serving in the registry's layout (the reference package's
  simplification: one shared block every 6 layers, 32 heads of 112, one
  SSD group) at d_model 3584 with seeded weights: a bf16
  prefill of 2 x 4096 tokens (13 ``flash_attention`` and 81 ``ssd_scan``
  launches; its profile holds that they ran the wgmma chunk state and
  chunk scan and no state-passing kernel), a float32 prefill of 2 x 512 tokens (cut to 15 of the 81
  layers: 2 of the 13 super-blocks and the tail) against the same tokens
  decoded one at a time and against the plain path, and the serve loop
  (batch 4, prompt 16, 32 generated tokens).
* Zamba2-7B at its published layout and widths
  (``zamba2_7b.published_config()``, the model of the benchmark's zamba2
  cell): a bf16 prefill of 2 x 4096 tokens through ``make_prefill_step``
  with 13 ``flash_attention`` launches at (64, 4096, 224), 81
  ``ssd_scan`` launches at 2 groups, 81 ``gate_norm`` and 81 ``causal_conv``
  launches, 108 ``rms_norm`` launches (a Mamba layer's, two a shared-block
  call's and the final norm), the
  first flash and SSD launches held against their plain versions and timed
  alone with their bounds (``[published-prefill]``);
* the Mamba2 mixer's gated-norm kernel at the two SSM cells' shapes
  (mamba2-2.7b: 16 x 4096 tokens, 80 heads of 64, one group; zamba2-7b:
  2 x 4096, 112 heads of 64, two groups), on operands laid out as the mixer
  holds them, against the plain chain, timed alone beside it and its byte
  bound (``[gate-norm]``); the mixer's causal-conv kernel at the same two
  cells' shapes (5,376 and 7,424 channels read through the in projection's
  row stride), bit for bit against the plain chain, timed alone beside it,
  ``F.conv1d(groups=C)`` + SiLU and its byte bound (``[causal-conv]``);
  the RMSNorm kernel at each cell's norm shape (mamba2-2.7b 65,536 x
  2,560; zamba2-7b 8,192 x 3,584 and x 7,168; olmoe-1b-7b 8,192 x 2,048;
  mixtral-8x22b 16,384 x 6,144; bf16), against the plain chain, timed alone
  on inputs that do not fit in L2, beside the plain chain,
  ``F.rms_norm(x, (D,), 1 + w, eps)`` and its byte bound (``[rms-norm]``).
* training, at deepseek-7b's published widths cut to 2 of its 30 layers
  (bf16, 8 x 4096 tokens per step in 4 microbatches, AdamW): a kernel
  launch under grad mode raises (``[train-grad-guard]``), and
  ``force_reference=True`` runs the plain oracles on the card with no launch
  (``[force-reference]``); 2 warm-up and 5
  timed steps, step 1 replayed bit-equal (``[train]``); one more step under
  the per-operation cost walker (``launch.op_analysis``): its flops against
  6 N tokens, its fused bytes, both roofline terms beside the measured
  step, and the walk's peak memory against a step's (``[step-cost]``); the same model
  through ``FTTrainer`` on 2 pods with a failure, its rollback to the
  pod's own checkpoint and re-execution bit-equal to a failure-free loop,
  its decisions equal to the CPU's, every checkpoint write and read timed
  (``[ft-train]``, ``[ft-io]``); ``launch.train --adaptive`` on the card
  and a static run reconciled against the renewal engine
  (``[ft-adaptive]``); the trained weights through the flash kernel at
  head_dim 128, against the plain path and decode (``[dense-prefill]``).
* the moe and encoder-decoder families and gradient compression, seeded
  weights at published widths: olmoe-1b-7b whole (16 layers, flat
  dispatch), a bf16 prefill of 2 x 4096 (16 flash launches, the share of
  slots dropped at capacity factor 1.25) and the serve loop, then float32
  with the capacity raised to E/K: the kernel path against the plain path
  at 2 x 1024 with the differing routes counted, decode of 2 x 128 against
  the forward (``[moe-prefill]``, ``[moe-decode]``); mixtral-8x22b cut to
  2 of 56 layers, bf16, 2 x 8192, its window of 4096 at group 6 through
  the flash kernel, held against the plain version and timed against a
  masked SDPA call (``[mixtral-prefill]``); whisper-medium whole (24 + 24
  layers), bf16, 8 x 1500 frames and 8 x 448 tokens (24 flash launches,
  decoder self-attention only), the decode loop with the encoder's output,
  float32 kernel path against the plain path and decode against the
  forward (``[encdec]``); olmoe's widths cut to 1 layer trained with AdamW
  on 4 x 2048 tokens, step 1 replayed bit-equal (``[moe-train]``); and
  ``wrap_optimizer`` (int8, top-k 5 %) on that step's gradients against the
  CPU port (``[compression]``).
* distribution, no kernel: deepseek-7b at its published widths cut to 2
  of 30 layers (as ``[train]``) on a 1 x 1 ("data", "model") NCCL mesh
  under the production sharding rules and activation policy: the train
  step (bf16, 8 x 4096 in 4 microbatches, AdamW), a 2 x 4096 prefill and
  32 decode steps at batch 4 with the cache placed by ``cache_specs``,
  each bit-equal to the unsharded step on the same seeded weights, with
  both wall times (``[mesh-steps]``); the dry run on the fake 256-rank
  production mesh for mamba2-370m x decode_32k and x train_4k and
  qwen2-72b x decode_32k (a CPU process each, started together after
  every timed phase): per-device argument, peak and temporary bytes
  against the card's memory, flops, fused bytes accessed and both roofline
  terms at the card's peaks, collective counts and wire bytes, train_4k
  held to the reference test's bars and its bytes to at least AdamW's
  writes (``[dryrun]``).

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

import concurrent.futures
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
# kernel (benchmarks/failure_sweep.py, roofline methodology: ~190 at 4
# ladder levels): ~30 per ladder level (the timer count with its IEEE
# division, the checkpoint time, feasibility, the sleep gate, the running
# argmin) and ~70 for the rest of the body
FLOP_PER_DECISION_BASE = 70.0
FLOP_PER_LADDER_LEVEL = 30.0

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
SHAPE_K, SHAPE_R = (1, FULL_EPOCHS), (1, 31, 1000)
SHAPE_KR = tuple((k, r) for k in SHAPE_K for r in SHAPE_R)
FLOAT_STATS = ("energy_ref", "energy_int", "saving", "balanced_energy",
               "end_time")
# the renewal kernel past phase 2b's shapes (phase 2c): 5-32 survivors x
# 3-8 ladder levels, 6 and 8 survivors, the bounds of the kernels' survivor
# counts (8 the last exact count, 9 and 16 the group's, 17 the first with
# one mapping, 33 and 64) and ladders (4, 5, 8, 16 levels), the caps; the
# fleet preset's shape (8 nodes, src/repro/campaign/presets.py, on the
# paper's 4-level ladder) and six wider clusters at the main path's size,
# the plain version timed on the fleet preset and the three widest
SHAPES_MAX_N = 4     # phase 2b's survivor counts
KERNEL_BOUND_SHAPES = tuple((n, nf) for n in (5, 7, 16, 32)
                            for nf in (3, 4, 5, 8)) \
    + ((3, 5), (3, 8), (4, 8), (6, 4), (8, 4), (8, 5), (8, 16), (9, 4),
       (9, 16), (17, 5), (33, 8), (64, 4), (64, 16))
FLEET_SHAPE = (7, 4)
WIDE_TIMED_SHAPES = (FLEET_SHAPE, (9, 4), (16, 8), (17, 5), (32, 8), (33, 4),
                     (64, 16))
WIDE_PLAIN_TIMED = (FLEET_SHAPE, (16, 8), (32, 8), (64, 16))
EARLIER_MAIN_PATH_MS = 0.04701   # the main path's kernel time before this kernel design (PERF.md §6)
# correlated rack failures (phase 5b), the reference's own fixtures
# (tests/test_topology.py): rack size (None: one rack of every node),
# shock MTBS in days, p_kill, age boost of the spared members in seconds
CORRELATED_TOPOLOGIES = {"gentle": (3, 8, 0.6, 1800.0),
                         "aggressive": (None, 3, 0.95, 3600.0)}

# the single-failure path: the six Table-4 scenarios x SWEEP_OFFSETS
# failure instants (linspace(0, 7200 s) + 0.318 s, benchmarks/failure_sweep.py's
# grid) x an eight-margin mu-band around the Table-4 band (3.67, 7.67);
# Monte-Carlo over MC_SAMPLES sampled instants per scenario
SWEEP_OFFSETS = 1 << 18
SWEEP_HORIZON_S = 7200.0
SWEEP_JITTER_S = 0.318
MU_BAND = (3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0)
SWEEP_CPU_STRIDE = 64        # the CPU check takes every 64th instant
SWEEP_ORACLE_OFFSETS = 16    # event-oracle instants per scenario
MC_SAMPLES = 1 << 20
MC_MTBF_S = 30 * 24 * 3600.0
TOL_TABLE4 = 1e-6            # compare on the card vs on the CPU
TOL_SWEEP = 1e-5             # sweep / Monte-Carlo floats, card vs CPU
TOL_SWEEP_ORACLE = 0.01      # sweep savings vs the event oracle (tests/test_sweep.py)
TOL_F64 = 1e-9               # the float64 scan vs the float64 host oracle
# checkpoint intervals of the 42-policy grid at which the float32 kernel
# meets exact ties the float64 engines keep (ROADMAP.md Queue 3, item 4)
KERNEL_TIE_INTERVALS_S = (2400.0, 4800.0, 9600.0)

# the operator stack: the reference benchmark's fleet (256 clusters, 32
# runs x 16 failures) and the campaign chaos cut's seed
FLEET_CLUSTERS = 256
FLEET_RUNS = 32
FLEET_FAILURES = 16
CAMPAIGN_CUT_SEED = 5

# the LM serving path: zamba2-7b in the registry's layout at d_model 3584
LM_ARCH = "zamba2-7b"
PREFILL_BATCH, PREFILL_LEN = 2, 4096
DECODE_CHECK_LEN = 512     # two SSD chunks, eight flash query blocks
DECODE_CHECK_LAYERS = 15   # of 81: 2 of 13 super-blocks and the 3-layer tail
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
LM_KERNEL_REPS = 10
# flash attention against its plain version: the kernel module's
# PLAIN_TOL (2e-5 in float32; atol 1e-4 / rtol 1e-2, one bf16 ulp, in
# bf16).  tests/test_kernels.py's bars: the SSD scan atol 2e-3 / rtol
# 1e-3; decode against the forward tests/test_models.py's
# test_decode_matches_forward (5e-3 / 1e-3)
TOL_SSD = (2e-3, 1e-3)
TOL_DECODE = (5e-3, 1e-3)
# the parts of one bf16 ssd_scan call (ssd_scan.KERNEL_NAMES; the fused
# chunk state leaves state_pass empty); a float32 call runs ssd_kernel alone
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


def first_call(i, *call):
    """``recorded``'s pick of the first call only."""
    return call if i == 0 else None


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def drive(rs, fn) -> tuple:
    """Run one entry point with the launch counts set to 0 just before it;
    returns (its result, the kernel launches it made, the recorded calls).
    Fails if it launched the kernel no time, or other than once per call."""
    from repro_torch import spans

    spans.reset_counts()
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


def shape_sweep(rs, failures, prng, ops, n: int, dev, key: int, seed: int,
                first: int, forced: bool) -> tuple:
    """The renewal kernel against its plain version at one shape over
    SHAPE_KR: per K of SHAPE_K two of the four (felled, compensated)
    variants (the other two at the other K; ``first`` picks which), the
    plain version run once at the largest R of SHAPE_R, and the kernel at
    every R on the first R runs of the same operands (runs are
    independent), launched by its own pick of lanes per run and, with
    ``forced``, in each mapping.  Returns (worst abs, worst rel, the
    variants seen, the cases)."""
    variants = ((False, True), (True, False), (True, True), (False, False))
    r_max = max(SHAPE_R)
    worst_abs = worst_rel = 0.0
    seen, n_cases = set(), 0
    for i, k in enumerate(SHAPE_K):
        g32, _ = failures.sample_renewal_gaps(
            failures.Exponential(MTBF_S), prng.PRNGKey(key + i), r_max, k,
            n + 1, dev)
        gaps_t = g32.T.contiguous()
        gen = torch.Generator(device="cpu").manual_seed(seed + i)
        felled = (torch.rand((k, n, r_max), generator=gen) < 0.15).float().to(dev)
        for use_fel, comp in (variants[(first + i) % 4],
                              variants[(first + i + 2) % 4]):
            fel = felled if use_fel else None
            want = rs.renewal_scan_reference(*ops, gaps_t, fel,
                                             compensated=comp)
            for r in SHAPE_R:
                gaps_r = gaps_t[:, :r].contiguous()
                fel_r = None if fel is None else fel[:, :, :r].contiguous()
                before = rs.LAUNCHES["renewal_scan"]
                outs = [rs.renewal_scan(*ops, gaps_r, fel_r, compensated=comp)]
                if rs.LAUNCHES["renewal_scan"] != before + 1:
                    raise Failed(f"n={n}: no counted launch")
                if forced:
                    outs += [rs._launch_cuda(*ops, gaps_r, fel_r, comp, lanes=g)
                             for g in rs.lane_choices(n)]
                torch.cuda.synchronize()
                want_r = {f: w[..., :r] for f, w in want.items()}
                for got in outs:
                    max_abs, max_rel = compare_outputs(got, want_r)
                    worst_abs = max(worst_abs, max_abs)
                    worst_rel = max(worst_rel, max_rel)
                n_cases += 1
            seen.add((use_fel, comp))
    return worst_abs, worst_rel, seen, n_cases


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
# the single-failure path and the float64 scan engine (plain PyTorch)
# ---------------------------------------------------------------------------

def max_rel_err(got, want) -> float:
    """Largest |got - want| / |want| (0 where both are 0)."""
    got = torch.as_tensor(np.asarray(got, np.float64)) if not isinstance(
        got, torch.Tensor) else got.double().cpu()
    want = torch.as_tensor(np.asarray(want, np.float64)) if not isinstance(
        want, torch.Tensor) else want.double().cpu()
    d = (got - want).abs()
    return float((d / want.abs().clamp_min(1e-300)).where(d > 0, 0.0).max())


def t_axis(x: torch.Tensor, n: int) -> int:
    """The axis of ``x`` that holds the ``n`` failure offsets."""
    return [i for i, s in enumerate(x.shape) if s == n][0]


def wall_ms_median(fn, reps: int) -> tuple:
    """Host milliseconds of ``fn`` ending in a synchronise: (the result of a
    warm call, the median of ``reps`` timed calls after it)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def table4_phase(card_line: str) -> None:
    """Phase 6: Table 4 through ``compare`` with Algorithm 1 on the card,
    against the published rows and against the same call on the CPU (which
    tests/test_torch_simulator.py holds against the reference)."""
    from repro_torch.core.scenarios import (TABLE4_PUBLISHED, paper_scenarios,
                                            table4_bars)
    from repro_torch.core.simulator import compare

    t0 = time.perf_counter()
    worst_cpu = 0.0
    for name, cfg in paper_scenarios().items():
        rows, _, _ = compare(cfg, device="cuda")
        rows_cpu, _, _ = compare(cfg, device="cpu")
        rel_bar, pct_bar = table4_bars(name)
        for r, rc in zip(rows, rows_cpu):
            comp, wait, save_j, save_pct = TABLE4_PUBLISHED[(name, r.node)]
            cpu_rel = abs(r.save_j - rc.save_j) / abs(rc.save_j)
            worst_cpu = max(worst_cpu, cpu_rel)
            pub_rel = abs(r.save_j - save_j) / save_j
            line("table4", scenario=name, node=r.node,
                 comp_action=repr(r.comp_action), wait_action=repr(r.wait_action),
                 published_actions=repr((comp, wait)), save_j=f"{r.save_j:.4f}",
                 published_save_j=f"{save_j:.2f}", rel_to_published=f"{pub_rel:.3e}",
                 save_pct=f"{r.save_pct:.4f}", published_pct=f"{save_pct:.2f}",
                 card_vs_cpu_rel=f"{cpu_rel:.3e}")
            if (r.comp_action, r.wait_action) != (comp, wait) or \
                    (r.comp_action, r.wait_action) != (rc.comp_action, rc.wait_action):
                raise Failed(f"table4 {name} node {r.node}: actions "
                             f"{(r.comp_action, r.wait_action)} differ")
            if pub_rel > rel_bar or abs(r.save_pct - save_pct) >= pct_bar:
                raise Failed(f"table4 {name} node {r.node}: saving {r.save_j} J "
                             f"({r.save_pct}%) beyond the published bars")
            if cpu_rel > TOL_TABLE4:
                raise Failed(f"table4 {name} node {r.node}: card and CPU "
                             f"savings differ by {cpu_rel:.3e}")
    line("table4", rows=18, card=repr(card_line),
         seconds=f"{time.perf_counter() - t0:.2f}",
         worst_card_vs_cpu_rel=f"{worst_cpu:.3e}")


def sweep_phase(card_line: str, sweep, scen) -> None:
    """Phase 7: the six scenarios x SWEEP_OFFSETS failure instants x the
    mu-band in one ``sweep_scenarios`` call on the card: timed, held against
    the same call on the CPU at every SWEEP_CPU_STRIDE-th offset and against
    the event oracle at SWEEP_ORACLE_OFFSETS instants per scenario."""
    from repro_torch.core.scenarios import shift_failure
    from repro_torch.core.simulator import simulate

    offsets = np.linspace(0.0, SWEEP_HORIZON_S, SWEEP_OFFSETS,
                          endpoint=False) + SWEEP_JITTER_S
    band = np.asarray(MU_BAND)
    call = lambda: sweep.sweep_scenarios(scen, offsets, mu1=band, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res = call()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(cuda_ms(call, reps=3, warmup=1))
    prof = device_profile(call)
    decisions = len(scen) * len(band) * SWEEP_OFFSETS * len(scen[0].survivors)
    line("sweep", card=repr(card_line), scenarios=len(scen), mu_band=len(band),
         offsets=SWEEP_OFFSETS, decisions=decisions, ms_median=f"{ms:.3f}",
         decisions_per_s=f"{decisions / (ms * 1e-3):.4e}",
         peak_memory_gb=f"{peak_gb:.3f}",
         kernel_launches=prof.get("launches", "not measured"),
         device_ms=("not measured" if prof["device_ms"] is None
                    else f"{prof['device_ms']:.3f}"),
         busy_share=("not measured" if prof["device_ms"] is None
                     else f"{prof['busy_share']:.4f}"))

    # the same call on the CPU at a strided subset
    idx = np.arange(0, SWEEP_OFFSETS, SWEEP_CPU_STRIDE)
    cpu = sweep.sweep_scenarios(scen, offsets[idx], mu1=band, device="cpu")
    sel = torch.as_tensor(idx)
    worst, n_fields = 0.0, 0
    pairs = [(f.name, getattr(res.decision, f.name), getattr(cpu.decision, f.name))
             for f in dataclasses.fields(res.decision)]
    pairs += [(f.name, getattr(res, f.name), getattr(cpu, f.name))
              for f in dataclasses.fields(res) if f.name != "decision"]
    for name, got, want in pairs:
        got = got.index_select(t_axis(got, SWEEP_OFFSETS), sel.to(got.device)).cpu()
        if got.shape != want.shape:
            raise Failed(f"sweep {name}: card {tuple(got.shape)} vs CPU "
                         f"{tuple(want.shape)}")
        n_fields += 1
        if got.dtype.is_floating_point:
            err = max_rel_err(got, want)
            worst = max(worst, err)
            if err > TOL_SWEEP:
                raise Failed(f"sweep {name}: card vs CPU rel {err:.3e} > {TOL_SWEEP}")
        elif not torch.equal(got, want):
            raise Failed(f"sweep {name}: card and CPU differ at "
                         f"{int((got != want).sum())} points")
    line("sweep", check="card vs cpu", offsets=len(idx), fields=n_fields,
         ints="exact", max_rel_err=f"{worst:.3e}", bar=TOL_SWEEP)

    # against the event oracle at each scenario's own margin (one band
    # entry): decisions exact, savings within 1%
    if len({c.mu1 for c in scen}) != 1:
        raise Failed("the oracle check reads one band entry for all scenarios")
    m_own = int(np.flatnonzero(band == scen[0].mu1)[0])
    t0 = time.perf_counter()
    worst_sav = 0.0
    for s, cfg in enumerate(scen):
        for t in range(0, SWEEP_OFFSETS, SWEEP_OFFSETS // SWEEP_ORACLE_OFFSETS):
            shifted = shift_failure(cfg, float(offsets[t]))
            ref = simulate(shifted, intervene=False, device="cuda")
            act = simulate(shifted, intervene=True, device="cuda")
            d = res.decision
            for i, node in enumerate(sorted(act.outcomes)):
                o = act.outcomes[node]
                measured = ref.outcomes[node].energy - o.energy
                if int(d.level[s, m_own, t, i]) != o.level or \
                        int(d.wait_action[s, m_own, t, i]) != int(o.wait_action):
                    raise Failed(f"sweep vs oracle {cfg.name} @ {offsets[t]}: "
                                 f"node {node} decision differs")
                pred = float(d.saving[s, m_own, t, i])
                denom = max(abs(measured), 0.01 * float(d.energy_reference[s, t, i]), 1.0)
                worst_sav = max(worst_sav, abs(pred - measured) / denom)
    if worst_sav >= TOL_SWEEP_ORACLE:
        raise Failed(f"sweep vs oracle savings {worst_sav:.3e} >= {TOL_SWEEP_ORACLE}")
    line("sweep", check="event oracle", instants_per_scenario=SWEEP_ORACLE_OFFSETS,
         mu1=float(band[m_own]), decisions="exact",
         worst_saving_rel=f"{worst_sav:.3e}", bar=TOL_SWEEP_ORACLE,
         seconds=f"{time.perf_counter() - t0:.2f}")
    for s, cfg in enumerate(scen):
        # scenario s at its own margin: band fields (S, M, T, N), the rest (S, T, N)
        pick = lambda x: x[s, m_own] if x.dim() == 4 else x[s]
        sm = sweep.summarize(dataclasses.replace(
            res, chain_ok=res.chain_ok[s], decision=dataclasses.replace(
                res.decision, **{f.name: pick(getattr(res.decision, f.name))
                                 for f in dataclasses.fields(res.decision)})))
        line("sweep", scenario=cfg.name, mu1=float(band[m_own]),
             mean_saving_j=f"{sm.mean_saving_j:.4f}",
             p5_saving_j=f"{sm.p5_saving_j:.4f}", p95_saving_j=f"{sm.p95_saving_j:.4f}",
             sleep_occupancy=f"{sm.sleep_occupancy:.6f}",
             min_freq_rate=f"{sm.min_freq_rate:.6f}",
             infeasible_rate=f"{sm.infeasible_rate:.6f}")
    del res


def monte_carlo_phase(card_line: str, sweep, prng, scen) -> None:
    """Phase 8: ``monte_carlo`` per scenario at MC_SAMPLES failure instants
    on the card, timed, held against the CPU at the same key.  Arrival times
    are a float64 cumsum of float32 unit-exponential draws, and ``log1p``
    may round a draw one ulp apart on the two devices (ROADMAP.md Queue 3,
    item 5), which shifts every later arrival: so the draws are compared
    (ulps), the CPU summary is computed from the card's own offsets and held
    at TOL_SWEEP, and the CPU's own same-key run is held there too when the
    draws agree bit for bit (printed either way)."""
    key = prng.PRNGKey(0)
    d_card = prng.exponential(key, (MC_SAMPLES,), "cuda").cpu()
    d_cpu = prng.exponential(key, (MC_SAMPLES,), "cpu")
    ulps = (d_card.view(torch.int32).long() - d_cpu.view(torch.int32).long()).abs()
    n_differ, max_ulp = int((ulps > 0).sum()), int(ulps.max())
    line("monte-carlo", check="unit draws card vs cpu", samples=MC_SAMPLES,
         differing=n_differ, max_ulps=max_ulp)
    if max_ulp > 2:
        raise Failed(f"monte-carlo: exponential draws {max_ulp} ulps apart")
    fields = [f.name for f in dataclasses.fields(sweep.MonteCarloSummary)
              if f.name != "annual_saving_by_strategy"]

    def rel(a, b) -> float:
        errs = [abs(getattr(a, f) - getattr(b, f)) / max(abs(getattr(b, f)), 1e-300)
                for f in fields]
        errs += [abs(a.annual_saving_by_strategy[k] - v) / max(abs(v), 1e-300)
                 for k, v in b.annual_saving_by_strategy.items()]
        return max(errs)

    for cfg in scen:
        wrap = 64.0 * (cfg.ckpt_interval + cfg.ckpt_duration)
        card_mc, ms = wall_ms_median(
            lambda: sweep.monte_carlo(cfg, key, n_samples=MC_SAMPLES,
                                      mtbf_s=MC_MTBF_S, device="cuda"), 3)
        offs = sweep.exponential_failure_offsets(key, MC_SAMPLES, MC_MTBF_S,
                                                 wrap, "cuda")
        same_offsets = sweep._monte_carlo_summary(cfg, offs, MC_MTBF_S, None, "cpu")
        err = rel(card_mc, same_offsets)
        own = sweep.monte_carlo(cfg, key, n_samples=MC_SAMPLES, mtbf_s=MC_MTBF_S,
                                device="cpu")
        own_err = rel(card_mc, own)
        line("monte-carlo", scenario=cfg.name, card=repr(card_line),
             samples=MC_SAMPLES, wall_ms_median=f"{ms:.3f}",
             mean_saving_j=f"{card_mc.mean_saving_j:.4f}",
             annual_saving_j=f"{card_mc.annual_saving_j:.6e}",
             sleep_occupancy=f"{card_mc.sleep_occupancy:.6f}",
             vs_cpu_same_offsets_rel=f"{err:.3e}",
             vs_cpu_same_key_rel=f"{own_err:.3e}")
        if err > TOL_SWEEP:
            raise Failed(f"monte-carlo {cfg.name}: card vs CPU on the same "
                         f"offsets rel {err:.3e} > {TOL_SWEEP}")
        if n_differ == 0 and own_err > TOL_SWEEP:
            raise Failed(f"monte-carlo {cfg.name}: card vs CPU at the same key "
                         f"rel {own_err:.3e} > {TOL_SWEEP}")


def renewal_f64_phase(card_line: str, sweep, optimize, scen, key, n_nodes: int,
                      kernel_summaries: dict, kernel_grid, grid_cfg, table,
                      makespans) -> None:
    """Phase 9: the float64 scan engine (``engine="scan"``, the default) at
    the main path's size, timed with its CUDA launches per call counted;
    held against the float64 host oracle on ORACLE_RUNS (TOL_F64, integers
    exact), bit for bit against itself on the CPU, and against the kernel
    engine at the same key (means within TOL_ORACLE); then the 42-policy
    grid on the scan against the kernel grid's means."""
    from repro_torch.core.scenarios import apply_policy

    run = lambda: sweep.renewal_monte_carlo_device(
        scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS, stats=True,
        device="cuda")
    stats, ms = wall_ms_median(run, 3)
    prof = device_profile(run)
    summaries = sweep.renewal_monte_carlo_scenarios(
        scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS)
    line("renewal-f64", card=repr(card_line), call="renewal_monte_carlo_device",
         engine="scan", scenarios=len(scen), runs=FULL_RUNS, epochs=FULL_EPOCHS,
         wall_ms_median=f"{ms:.3f}",
         kernel_launches_per_call=prof.get("launches", "not measured"),
         device_ms=("not measured" if prof["device_ms"] is None
                    else f"{prof['device_ms']:.3f}"),
         busy_share=("not measured" if prof["device_ms"] is None
                     else f"{prof['busy_share']:.4f}"))

    gaps, failed = sweep.renewal_failure_gaps(key, FULL_RUNS, n_nodes,
                                              FULL_EPOCHS, MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    # the per-epoch view on the card against itself on the CPU, bit for bit
    full_card = sweep.renewal_compose_device(scen, gaps_o, MAKESPAN_S,
                                             failed_node=failed_o, device="cuda")
    full_cpu = sweep.renewal_compose_device(scen, gaps_o, MAKESPAN_S,
                                            failed_node=failed_o, device="cpu")
    n_diff = 0
    for f in ("energy_ref", "energy_int", "end_time", "balanced_energy",
              "epoch_ref", "epoch_int", "t_fail", "valid", "n_failures"):
        n_diff += int((getattr(full_card, f).cpu() != getattr(full_cpu, f)).sum())
    for f in ("level", "wait_action", "energy_intervened"):
        n_diff += int((getattr(full_card.decision, f).cpu()
                       != getattr(full_cpu.decision, f)).sum())
    worst = 0.0
    for s, cfg in enumerate(scen):
        host = sweep.renewal_compose(cfg, gaps_o, MAKESPAN_S, failed_node=failed_o,
                                     device="cpu")
        for f in ("n_failures", "truncated"):
            if not torch.equal(getattr(stats, f)[s, :ORACLE_RUNS].cpu().long(),
                               getattr(host, f).long()):
                raise Failed(f"renewal-f64 {cfg.name}: {f} differ from the oracle")
        v = host.valid[:, :, None].expand(host.decision.level.shape)
        d = host.decision
        for f, mask in (("n_sleep", d.wait_action == 2), ("n_min_freq", d.wait_action == 1),
                        ("n_comp_changed", d.comp_changed),
                        ("n_infeasible", ~d.feasible_any)):
            if not torch.equal(getattr(stats, f)[s, :ORACLE_RUNS].cpu().long(),
                               (v & mask).sum(dim=(1, 2))):
                raise Failed(f"renewal-f64 {cfg.name}: {f} differ from the oracle")
        for f in ("energy_ref", "energy_int", "balanced_energy", "end_time"):
            worst = max(worst, max_rel_err(getattr(stats, f)[s, :ORACLE_RUNS],
                                           getattr(host, f)))
        worst = max(worst, float(((stats.saving[s, :ORACLE_RUNS].cpu() - host.saving).abs()
                                  / host.energy_ref).max()))
    if worst > TOL_F64:
        raise Failed(f"renewal-f64: rel {worst:.3e} against the oracle > {TOL_F64}")
    line("renewal-f64", check="host oracle", runs=ORACLE_RUNS, ints="exact",
         max_rel_err=f"{worst:.3e}", bar=TOL_F64,
         card_vs_cpu_differing_entries=n_diff)
    if n_diff:
        raise Failed(f"renewal-f64: card and CPU scans differ at {n_diff} entries")

    worst_k = 0.0
    for cfg in scen:
        a, b = summaries[cfg.name], kernel_summaries[cfg.name]
        if (a.mean_failures, a.failure_count_hist, a.sleep_occupancy,
                a.min_freq_rate, a.comp_change_rate, a.infeasible_rate) != \
                (b.mean_failures, b.failure_count_hist, b.sleep_occupancy,
                 b.min_freq_rate, b.comp_change_rate, b.infeasible_rate):
            raise Failed(f"renewal-f64 {cfg.name}: counts differ from the kernel's")
        for f in ("mean_energy_ref_j", "mean_energy_int_j"):
            worst_k = max(worst_k, abs(getattr(a, f) / getattr(b, f) - 1))
        worst_k = max(worst_k, abs(a.mean_saving_j - b.mean_saving_j)
                      / b.mean_energy_ref_j)
        line("renewal-f64", scenario=cfg.name, mean_failures=f"{a.mean_failures:.6f}",
             mean_saving_pct=f"{a.mean_saving_pct:.6f}",
             mean_energy_int_j=f"{a.mean_energy_int_j:.6e}")
    if worst_k > TOL_ORACLE:
        raise Failed(f"renewal-f64: means {worst_k:.3e} from the kernel's > {TOL_ORACLE}")
    line("renewal-f64", check="kernel engine, same key", counts="exact",
         max_mean_rel_err=f"{worst_k:.3e}", bar=TOL_ORACLE)

    # the 42-policy grid on the scan
    grid_call = lambda: optimize.evaluate_policy_grid(
        grid_cfg, table, key, work_s=GRID_WORK_S, n_runs=FULL_RUNS,
        max_failures=FULL_EPOCHS, mtbf_s=GRID_MTBF_S)
    torch.cuda.reset_peak_memory_stats()
    scan_grid, g_ms = wall_ms_median(grid_call, 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rel = np.abs(scan_grid.mean_energy_j / kernel_grid.mean_energy_j - 1)
    # at these intervals the float32 kernel breaks exact move-ahead ties the
    # float64 engines keep (ROADMAP.md Queue 3, item 4): the scan is held
    # there against the float64 oracle below, not against the kernel
    tie = np.isin(np.round(table.ckpt_interval, 6), KERNEL_TIE_INTERVALS_S)
    if rel[~tie].max() > TOL_ORACLE:
        raise Failed(f"renewal-f64 grid: means {rel[~tie].max():.3e} from the "
                     f"kernel's > {TOL_ORACLE}")
    gaps, failed = sweep.renewal_failure_gaps(key, FULL_RUNS, n_nodes,
                                              FULL_EPOCHS, GRID_MTBF_S)
    gaps_o, failed_o = gaps[:ORACLE_RUNS].cpu(), failed[:ORACLE_RUNS].cpu()
    worst_g = 0.0
    for ival in np.unique(table.ckpt_interval):
        p = int(np.flatnonzero(table.ckpt_interval == ival)[0])
        host = sweep.renewal_compose(apply_policy(grid_cfg, **table.policy(p)),
                                     gaps_o, float(makespans[p]),
                                     failed_node=failed_o, device="cpu")
        if not np.array_equal(scan_grid.n_failures[p, :ORACLE_RUNS],
                              host.n_failures.numpy()):
            raise Failed(f"renewal-f64 grid policy {p}: failure counts differ")
        for f in ("energy_ref", "energy_int", "end_time"):
            worst_g = max(worst_g, max_rel_err(getattr(scan_grid, f)[p, :ORACLE_RUNS],
                                               getattr(host, f)))
    if worst_g > TOL_F64:
        raise Failed(f"renewal-f64 grid: rel {worst_g:.3e} against the oracle > {TOL_F64}")
    line("renewal-f64", check="policy grid", card=repr(card_line),
         policies=len(table), runs=FULL_RUNS, epochs=FULL_EPOCHS,
         wall_ms_median=f"{g_ms:.3f}", peak_memory_gb=f"{peak_gb:.3f}",
         argmin=scan_grid.best, kernel_argmin=kernel_grid.best,
         max_mean_rel_vs_kernel_untied=f"{rel[~tie].max():.3e}",
         max_mean_rel_vs_kernel_tied=f"{rel[tie].max():.3e}",
         tied_intervals=sorted(set(table.ckpt_interval[tie].round(3).tolist())),
         oracle_policies=len(np.unique(table.ckpt_interval)),
         oracle_max_rel_err=f"{worst_g:.3e}")


# ---------------------------------------------------------------------------
# the failure-process axis and correlated rack failures, and the renewal
# kernel past its fast shapes
# ---------------------------------------------------------------------------

STAT_INTS = ("n_failures", "truncated", "n_points", "n_sleep", "n_min_freq",
             "n_comp_changed", "n_infeasible")


def check_stats_against_oracle(phase: str, sweep, cfg, stats_row: dict, gaps,
                               failed, felled, tol: float) -> float:
    """The first ORACLE_RUNS runs of one lane's stats against the float64
    host oracle on the same histories (``felled`` an (R, K, N) survivor-slot
    mask or None): every integer count exact per run (failures, truncation,
    decision points and the four action counts over valid, non-felled
    points); energies, balanced energy and end time within ``tol`` relative
    per run, the saving within ``tol`` of the reference energy.  Returns
    the largest error."""
    host = sweep.renewal_compose(cfg, gaps, MAKESPAN_S, failed_node=failed,
                                 felled=felled, device="cpu")
    d = host.decision
    v = host.valid[:, :, None].expand(d.level.shape)
    if felled is not None:
        v = v & ~torch.as_tensor(felled, dtype=torch.bool)
    want = {"n_failures": host.n_failures, "truncated": host.truncated,
            "n_points": v.sum(dim=(1, 2)),
            "n_sleep": (v & (d.wait_action == 2)).sum(dim=(1, 2)),
            "n_min_freq": (v & (d.wait_action == 1)).sum(dim=(1, 2)),
            "n_comp_changed": (v & d.comp_changed).sum(dim=(1, 2)),
            "n_infeasible": (v & ~d.feasible_any).sum(dim=(1, 2))}
    for f in STAT_INTS:
        got = stats_row[f][:ORACLE_RUNS].cpu().long()
        if not torch.equal(got, want[f].long()):
            n_bad = int((got != want[f].long()).sum())
            raise Failed(f"{phase} {cfg.name}: {f} differs from the oracle "
                         f"in {n_bad} runs")
    worst = 0.0
    for f in ("energy_ref", "energy_int", "balanced_energy", "end_time"):
        worst = max(worst, max_rel_err(stats_row[f][:ORACLE_RUNS],
                                       getattr(host, f)))
    sav = stats_row["saving"][:ORACLE_RUNS].double().cpu()
    worst = max(worst, float(((sav - host.saving).abs()
                              / host.energy_ref).max()))
    if worst > tol:
        raise Failed(f"{phase} {cfg.name}: rel {worst:.3e} against the "
                     f"float64 oracle > {tol}")
    return worst


def stats_row(stats, s: int) -> dict:
    """Lane ``s`` of a ``RenewalDeviceStats`` (or of the kernel's output
    dict) as a dict of (R,) tensors."""
    get = (lambda f: stats[f]) if isinstance(stats, dict) else \
        (lambda f: getattr(stats, f))
    return {f: get(f)[s] for f in FLOAT_STATS + STAT_INTS}


def kernel_bounds_phase(card_line: str, rs, failures, prng, scen_ops, dev,
                        n_scen: int) -> tuple:
    """Phase 2c: the survivor counts and ladder depths past phase 2b's
    (KERNEL_BOUND_SHAPES), with and without shocks, compensated and not,
    the kernel's own pick of lanes per run and, where the shape has two
    mappings, each forced, every launch bit-equal to the plain version;
    then the fleet preset's shape (7 survivors, 4 levels: the Table-4
    scenarios widened) and WIDE_TIMED_SHAPES' wider clusters at the main
    path's size, each bit-equal with and without shocks and timed alone
    against its bound (the plain version on WIDE_PLAIN_TIMED).  Returns
    (worst abs, worst rel) against the plain version."""
    worst_abs = worst_rel = 0.0
    for j, (n, nf) in enumerate(KERNEL_BOUND_SHAPES):
        ops = with_shape(scen_ops, n, nf)
        shape_abs, shape_rel, seen, _ = shape_sweep(
            rs, failures, prng, ops, n, dev, key=200, seed=31, first=j,
            forced=len(rs.lane_choices(n)) > 1)
        if shape_rel != 0.0:
            raise Failed(f"kernel-bounds n={n} nf={nf}: floats not bit-equal "
                         f"(rel {shape_rel:.3e})")
        worst_abs = max(worst_abs, shape_abs)
        if len(seen) != 4:
            raise Failed(f"kernel-bounds n={n} nf={nf}: only {sorted(seen)}")
        line("kernel-bounds", survivors=n, levels=nf, lanes=n_scen,
             kernels="/".join(rs.kernel_name(n, nf, g) for g in rs.lane_choices(n)),
             shapes="K,R=" + "/".join(f"{k}x{r}" for k, r in SHAPE_KR),
             felled_compensated="all four", lanes_per_run="auto/" + "/".join(
                 map(str, rs.lane_choices(n))), bit_equal=True,
             max_abs_err=f"{shape_abs:.6g}")

    # the fleet preset's shape and the wider clusters at the main path's size
    for n, nf in WIDE_TIMED_SHAPES:
        ops = with_shape(scen_ops, n, nf)
        g32, _ = failures.sample_renewal_gaps(
            failures.Exponential(MTBF_S), prng.PRNGKey(1), FULL_RUNS,
            FULL_EPOCHS, n + 1, dev)
        gaps_t = g32.T.contiguous()
        gen = torch.Generator(device="cpu").manual_seed(5)
        felled = (torch.rand((FULL_EPOCHS, n, FULL_RUNS), generator=gen) < 0.15
                  ).float().to(dev)
        for fel in (None, felled):
            args = (*ops, gaps_t) + (() if fel is None else (fel,))
            out = rs.renewal_scan(*args)
            p_ms = None
            if fel is None and (n, nf) in WIDE_PLAIN_TIMED:
                # the plain version timed without shocks, its first call
                # the one the kernel is held against
                wants = []
                p_ms = statistics.median(cuda_ms(
                    lambda: wants.append(rs.renewal_scan_reference(*args)),
                    reps=3, warmup=0))
                want = wants[0]
            else:
                want = rs.renewal_scan_reference(*args)
            torch.cuda.synchronize()
            max_abs, max_rel = compare_outputs(out, want)
            if max_rel != 0.0:
                raise Failed(f"kernel-bounds n={n} nf={nf} at the main path's "
                             f"size: floats not bit-equal ({max_rel:.3e})")
            worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
            k_ms, host_ms = kernel_only_ms(lambda: rs.renewal_scan(*args),
                                           n=KERNEL_REPS)
            b_ms, b_by, n_bytes, occ = renewal_bound(args, out, n)
            line("kernel-bounds", shape="fleet preset" if (n, nf) == FLEET_SHAPE
                 else f"{n}x{nf}", card=repr(card_line), survivors=n, levels=nf,
                 kernel=rs.kernel_name(n, nf, renewal_lanes(rs, n, nf, n_scen)),
                 lanes=n_scen, runs=FULL_RUNS, epochs=FULL_EPOCHS,
                 felled=fel is not None, bit_equal=True, kernel_ms=f"{k_ms:.5f}",
                 plain_ms="not measured" if p_ms is None else f"{p_ms:.2f}",
                 wrapper_host_ms=f"{host_ms:.5f}", occurring_decisions=occ,
                 bytes=n_bytes, bound_ms=f"{b_ms:.5f}", bound_by=b_by,
                 bound_share=f"{b_ms / k_ms:.4f}")
    return worst_abs, worst_rel


# survivor counts at which the run kernel's occupancy is printed
RUN_OCCUPANCY_N = (9, 17, 33, 64)


def renewal_lanes(rs, n: int, nf: int, n_lanes: int,
                  n_runs: int = FULL_RUNS) -> int:
    """The lanes per run the renewal kernel picks for a launch."""
    import ctypes
    from repro_torch.kernels import _build

    pick = _build.load_library(*rs.LIBRARY).renewal_scan_lanes_per_run
    pick.argtypes = [ctypes.c_int] * 4
    return pick(n, nf, n_lanes, n_runs)


def correlated_phase(card_line: str, rs, sweep, topology, failures, prng,
                     scen, key, n_nodes: int) -> tuple:
    """Phase 5b: correlated rack failures at the main path's size — the six
    scenarios x FULL_RUNS x FULL_EPOCHS, Weibull k = 0.7 at MTBF_S, under
    the reference's gentle and aggressive topologies.  The kernel engine
    (one counted launch with the felled operand, held bit-equal to its
    plain version) and the float64 scan against the float64 oracle on the
    card's histories (1e-4 and 1e-9, every integer count exact); the scan
    on the card against itself on the CPU bit for bit; the sampler timed
    with its launches; same-key histories of the card and the CPU compared.
    Returns (worst abs, worst rel) of the kernel against its plain version."""
    dev = torch.device("cuda")
    proc = failures.Weibull.from_mtbf(0.7, MTBF_S)
    worst_abs = worst_rel = 0.0
    n_multi_all = n_all_all = 0
    for label, (rack, mtbs_d, p_kill, boost) in CORRELATED_TOPOLOGIES.items():
        topo = topology.rack_topology(n_nodes, rack or n_nodes,
                                      shock_mtbs_s=mtbs_d * 24 * 3600.0,
                                      p_kill=p_kill, age_boost_s=boost)
        sample = lambda: topology.sample_correlated_renewal_gaps(
            topo, proc, key, FULL_RUNS, FULL_EPOCHS, n_nodes, dev)
        (gaps32, fmask, primary), s_ms = wall_ms_median(sample, 3)
        prof = device_profile(sample)
        summaries, launches, (call,) = drive(
            rs, lambda: sweep.renewal_monte_carlo_scenarios(
                scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
                process=proc, topology=topo, engine="kernel"))
        args, kw, out = call
        felled = topology.survivor_slot_mask(fmask, primary)
        if len(args) < 5 or not torch.equal(
                args[4], felled.permute(1, 2, 0).float()):
            raise Failed(f"correlated {label}: the kernel did not get the "
                         "sampler's felled slots")
        max_abs, max_rel = compare_outputs(
            out, rs.renewal_scan_reference(*args, **kw))
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        k_ms, host_ms = kernel_only_ms(lambda: rs.renewal_scan(*args, **kw),
                                       n=KERNEL_REPS)
        b_ms, b_by, n_bytes, occ = renewal_bound(args, out, n_nodes - 1)
        # epochs that occur in some scenario, by how many nodes they fell
        occurs = out["valid"].bool().any(dim=0).T                  # (R, K)
        n_fell = fmask.sum(dim=-1)
        n_multi = int((occurs & (n_fell > 1)).sum())
        n_all = int((occurs & (n_fell == n_nodes)).sum())
        n_multi_all, n_all_all = n_multi_all + n_multi, n_all_all + n_all
        line("correlated", topology=label, card=repr(card_line),
             label=repr(topo.label()), rack=rack or n_nodes,
             shock_mtbs_days=mtbs_d, p_kill=p_kill, age_boost_s=boost,
             scenarios=len(scen), runs=FULL_RUNS, epochs=FULL_EPOCHS,
             launches=launches, kernel_vs_plain="bit-equal" if max_rel == 0
             else f"rel {max_rel:.3e}", sampler_ms_median=f"{s_ms:.3f}",
             sampler_launches=prof.get("launches", "not measured"),
             kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
             occurring_decisions=occ, bytes=n_bytes, bound_ms=f"{b_ms:.5f}",
             bound_by=b_by, bound_share=f"{b_ms / k_ms:.4f}",
             multi_felled_epochs=n_multi, all_felled_epochs=n_all)
        if n_multi == 0:
            raise Failed(f"correlated {label}: no epoch felled several nodes")

        # the oracle on the card's histories, kernel and scan
        gaps_o = gaps32[:ORACLE_RUNS].double().cpu()
        prim_o = primary[:ORACLE_RUNS].cpu()
        fel_o = felled[:ORACLE_RUNS].cpu()
        scan_stats, scan_ms = wall_ms_median(
            lambda: sweep.renewal_monte_carlo_device(
                scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
                process=proc, topology=topo, stats=True), 2)
        worst_k = worst_s = 0.0
        for s, cfg in enumerate(scen):
            worst_k = max(worst_k, check_stats_against_oracle(
                f"correlated {label} kernel", sweep, cfg, stats_row(out, s),
                gaps_o, prim_o, fel_o, TOL_ORACLE))
            worst_s = max(worst_s, check_stats_against_oracle(
                f"correlated {label} scan", sweep, cfg,
                stats_row(scan_stats, s), gaps_o, prim_o, fel_o, TOL_F64))
            sm = summaries[cfg.name]
            check_summary(cfg.name, sm, out, s)
            line("correlated", topology=label, scenario=cfg.name,
                 mean_failures=f"{sm.mean_failures:.6f}",
                 felled_per_run=f"{sum(sm.per_node_failures):.6f}",
                 mean_saving_pct=f"{sm.mean_saving_pct:.6f}",
                 sleep_occupancy=f"{sm.sleep_occupancy:.6f}")
        if not torch.equal(scan_stats.failed_counts.cpu(),
                           (out["valid"].bool().transpose(1, 2)[..., None]
                            & fmask[None]).sum(dim=(1, 2)).int().cpu()):
            raise Failed(f"correlated {label}: per-node counts differ")
        # the scan on the card against itself on the CPU, same histories
        full = [sweep.renewal_compose_device(
            scen, gaps_o, MAKESPAN_S, failed_node=prim_o, felled=fel_o,
            device=d) for d in ("cuda", "cpu")]
        n_diff = sum(int((getattr(full[0], f).cpu() != getattr(full[1], f)).sum())
                     for f in ("energy_ref", "energy_int", "end_time",
                               "balanced_energy", "epoch_ref", "epoch_int",
                               "epoch_failed", "valid", "n_failures"))
        # same-key histories drawn on the CPU
        g_cpu, m_cpu, p_cpu = topology.sample_correlated_renewal_gaps(
            topo, proc, key, FULL_RUNS, FULL_EPOCHS, n_nodes, "cpu")
        line("correlated", topology=label, check="float64 oracle",
             runs=ORACLE_RUNS, ints="exact",
             kernel_max_rel_err=f"{worst_k:.3e}", kernel_bar=TOL_ORACLE,
             scan_max_rel_err=f"{worst_s:.3e}", scan_bar=TOL_F64,
             scan_wall_ms_median=f"{scan_ms:.3f}",
             scan_card_vs_cpu_differing_entries=n_diff,
             same_key_cpu_gaps_differing=int((g_cpu != gaps32.cpu()).sum()),
             same_key_cpu_masks_differing=int((m_cpu != fmask.cpu()).sum()),
             same_key_cpu_primaries_differing=int((p_cpu != primary.cpu()).sum()),
             histories=gaps32.numel())
        if n_diff:
            raise Failed(f"correlated {label}: card and CPU scans differ at "
                         f"{n_diff} entries")
    if n_all_all == 0:
        raise Failed("correlated: no epoch felled every node")
    return worst_abs, worst_rel


def process_catalog(failures) -> dict:
    """The failure processes of phase 5c, each at MTBF_S: LogNormal
    (sigma 1), Gamma (k 0.5 and 3), and empirical traces (one shared and
    one per node) of Weibull(0.8)-shaped gaps drawn from a seed and scaled
    to the MTBF."""
    rng = np.random.default_rng(23)
    shared = rng.weibull(0.8, 512)
    per_node = rng.weibull(0.8, (4, 512))
    return {
        "lognormal-s1": failures.LogNormal.from_mtbf(MTBF_S, 1.0),
        "gamma-k0.5": failures.Gamma.from_mtbf(0.5, MTBF_S),
        "gamma-k3": failures.Gamma.from_mtbf(3.0, MTBF_S),
        "trace-1d": failures.EmpiricalTrace(shared * MTBF_S / shared.mean()),
        "trace-per-node": failures.EmpiricalTrace(
            per_node * MTBF_S / per_node.mean(axis=1, keepdims=True)),
    }


def processes_phase(card_line: str, rs, sweep, failures, scen, key,
                    n_nodes: int) -> tuple:
    """Phase 5c: every failure process through both engines on the main
    path's shape: the kernel (one counted launch, bit-equal to its plain
    version) within TOL_ORACLE and the scan within TOL_F64 of the float64
    oracle on the card's histories, integer counts exact; the card's
    same-key histories against the CPU's.  Returns (worst abs, worst rel)
    of the kernel against its plain version."""
    dev = torch.device("cuda")
    worst_abs = worst_rel = 0.0
    for label, proc in process_catalog(failures).items():
        t0 = time.perf_counter()
        kstats, launches, (call,) = drive(
            rs, lambda: sweep.renewal_monte_carlo_device(
                scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
                process=proc, stats=True, engine="kernel"))
        k_wall = (time.perf_counter() - t0) * 1e3
        args, kw, out = call
        max_abs, max_rel = compare_outputs(
            out, rs.renewal_scan_reference(*args, **kw))
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        sample = lambda: failures.sample_renewal_gaps(
            proc, key, FULL_RUNS, FULL_EPOCHS, n_nodes, dev)
        (g32, failed), s_ms = wall_ms_median(sample, 2)
        scan_stats, scan_ms = wall_ms_median(
            lambda: sweep.renewal_monte_carlo_device(
                scen, key, n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
                process=proc, stats=True), 1)
        gaps_o = g32[:ORACLE_RUNS].double().cpu()
        failed_o = failed[:ORACLE_RUNS].cpu()
        worst_k = worst_s = 0.0
        for s, cfg in enumerate(scen):
            worst_k = max(worst_k, check_stats_against_oracle(
                f"processes {label} kernel", sweep, cfg, stats_row(kstats, s),
                gaps_o, failed_o, None, TOL_ORACLE))
            worst_s = max(worst_s, check_stats_against_oracle(
                f"processes {label} scan", sweep, cfg,
                stats_row(scan_stats, s), gaps_o, failed_o, None, TOL_F64))
        g_cpu, f_cpu = failures.sample_renewal_gaps(
            proc, key, FULL_RUNS, FULL_EPOCHS, n_nodes, "cpu")
        g_card = g32.cpu()
        differ = g_cpu != g_card
        rel = ((g_cpu.double() - g_card.double()).abs()
               / g_card.double().abs().clamp_min(1e-30))
        line("processes", process=label, label=repr(proc.label()),
             card=repr(card_line), scenarios=len(scen), runs=FULL_RUNS,
             epochs=FULL_EPOCHS, launches=launches,
             kernel_vs_plain="bit-equal" if max_rel == 0 else f"rel {max_rel:.3e}",
             kernel_entry_wall_ms=f"{k_wall:.3f}",
             sampler_ms_median=f"{s_ms:.3f}", scan_wall_ms=f"{scan_ms:.3f}",
             mean_failures=f"{float(kstats.n_failures.float().mean()):.6f}",
             kernel_oracle_max_rel=f"{worst_k:.3e}",
             scan_oracle_max_rel=f"{worst_s:.3e}", ints="exact",
             same_key_cpu_gaps_differing=int(differ.sum()),
             same_key_cpu_gaps_max_rel=f"{float(rel.max()):.3e}",
             same_key_cpu_failed_differing=int((f_cpu != failed.cpu()).sum()),
             histories=g32.numel())
    return worst_abs, worst_rel


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
    e.g. ``flash_wgmma_kernel<112>``: the last length-prefixed identifier
    that names a kernel (``kernel``, ``chunk_scan`` or ``chunk_state`` in
    it) and ends where a name does (template arguments, the end of the
    nested name or the parameters follow)."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            n, start = int(m.group()[i:]), m.end()
            ident, rest = mangled[start:start + n], mangled[start + n:]
            if len(ident) == n and any(w in ident for w in (
                    "kernel", "chunk_scan", "chunk_state")) and \
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
    registers, stack frame, spill stores and loads (bytes) and static
    shared memory."""
    out, cur = [], None
    for r in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", r)
        if m:
            cur = {"function": kernel_name(m.group(1)), "stack_frame": 0,
                   "spill_stores": 0, "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", r)
        if m:
            cur["stack_frame"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
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
                 [f"{fa.BF16_KERNEL[head_dim]}<{head_dim}>" if dtype
                  else f"flash_kernel<{head_dim}>"]),
                (ssd, "ssd_scan_occupancy", (p, n, chunk),
                 [f"{ssd.chunk_state_kernel(p, n, chunk)}<{p},{n}>",
                  "ssd_kernel_state_pass",
                  f"{ssd.chunk_scan_kernel(p, n, chunk)}<{p},{n}>"] if dtype
                 else [f"ssd_kernel<{p},{n}>"])):
            lib = _build.load_library(*module.LIBRARY)
            fn = getattr(lib, fn_name)
            fn.argtypes = [ctypes.c_int] * (len(shape) + 1) + [ptr] * 3
            blocks, threads, smem = ((ctypes.c_int * 3)() for _ in range(3))
            _build.check_launch(lib, module.LIBRARY[0],
                                fn(*shape, dtype, blocks, threads, smem))
            # a kernel the call does not launch reports 0 threads (the
            # fused chunk state leaves no state-passing kernel)
            rows += [(name, blocks[i], threads[i], smem[i])
                     for i, name in enumerate(names) if threads[i]]
        for name, b, t, sm in rows:
            line("occupancy", kernel=name, dtype=kind, threads=t,
                 dynamic_smem_bytes=sm, blocks_per_sm=b, warps_per_sm=b * t // 32)


def check_flash_tiles(fa) -> None:
    """The bf16 flash kernel and tiles of every head dim, as the C library
    reports them (flash_attention_bf16_tiles), against the module's
    BF16_KERNEL and BF16_TILES, which the CPU tests emulate."""
    import ctypes
    from repro_torch.kernels import _build

    lib = _build.load_library(*fa.LIBRARY)
    fn = lib.flash_attention_bf16_tiles
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
    for d in fa.SUPPORTED_HEAD_DIMS:
        bq, bk, stages, wgmma = (ctypes.c_int() for _ in range(4))
        _build.check_launch(lib, "flash_attention", fn(d, bq, bk, stages, wgmma))
        got = ((bq.value, bk.value, stages.value),
               "flash_wgmma_kernel" if wgmma.value else "flash_mma_kernel")
        line("flash-tiles", head_dim=d, kernel=got[1], block_q=bq.value,
             block_k=bk.value, stages=stages.value)
        if got != (fa.BF16_TILES[d], fa.BF16_KERNEL[d]):
            raise Failed(f"flash bf16 tiles at head dim {d}: the library has "
                         f"{got}, flash_attention.py {fa.BF16_TILES[d]}, "
                         f"{fa.BF16_KERNEL[d]}")


def check_ssd_tiles(ssd, shapes) -> None:
    """The bf16 chunk-scan kernel of each (P, N, chunk) in ``shapes``, and
    for the wgmma kernel the query tiles of its first consumer and its
    ring, as the C library reports them (ssd_scan_bf16_chunk_scan), against
    the module's BF16_CHUNK_SCAN, consumer_tiles and WGMMA_RING, which the
    CPU tests emulate; and its chunk-state kernel
    (ssd_scan_bf16_chunk_state) against BF16_CHUNK_STATE."""
    import ctypes
    from repro_torch.kernels import _build

    lib = _build.load_library(*ssd.LIBRARY)
    fn = lib.ssd_scan_bf16_chunk_scan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fs = lib.ssd_scan_bf16_chunk_state
    fs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    for p, n, chunk in sorted(set(shapes)):
        wgmma, first, slots, s_bufs, fused = (ctypes.c_int() for _ in range(5))
        _build.check_launch(lib, "ssd_scan", fn(p, n, chunk, wgmma, first,
                                                slots, s_bufs))
        _build.check_launch(lib, "ssd_scan", fs(p, n, chunk, fused))
        state_kernel = "ssd_wgmma_chunk_state" if fused.value \
            else "ssd_kernel_chunk_state"
        if state_kernel != ssd.chunk_state_kernel(p, n, chunk):
            raise Failed(f"SSD bf16 chunk state at (P, N, chunk) {(p, n, chunk)}: "
                         f"the library runs {state_kernel}, ssd_scan.py "
                         f"{ssd.chunk_state_kernel(p, n, chunk)}")
        kernel = "ssd_wgmma_chunk_scan" if wgmma.value else "ssd_kernel_chunk_scan"
        tiles = tuple(t for t in range(4) if first.value >> t & 1)
        got = (kernel, tiles if wgmma.value else None,
               (slots.value, s_bufs.value) if wgmma.value else None)
        want_kernel = ssd.chunk_scan_kernel(p, n, chunk)
        wgmma_want = want_kernel == "ssd_wgmma_chunk_scan"
        want = (want_kernel,
                ssd.consumer_tiles(-(-chunk // 64))[0] if wgmma_want else None,
                ssd.WGMMA_RING[(p, n)] if wgmma_want else None)
        line("ssd-tiles", p=p, n=n, chunk=chunk, chunk_state_kernel=state_kernel,
             kernel=kernel,
             consumer_tiles=(tiles, ssd.consumer_tiles(-(-chunk // 64))[1])
             if wgmma.value else None,
             tile_slots=slots.value, s_in_buffers=s_bufs.value)
        if got != want:
            raise Failed(f"SSD bf16 chunk scan at (P, N, chunk) {(p, n, chunk)}: "
                         f"the library has {got}, ssd_scan.py {want}")


def print_renewal_occupancy(rs, launches: dict) -> None:
    """Blocks per SM of every instantiation of the renewal kernel (each
    survivor count up to FAST_MAX_N and GROUP_N, each mapping, both
    unrolled ladder depths; the run kernel, whose shared memory grows with
    the survivors, at RUN_OCCUPANCY_N), and for the path's launches
    (``launches``: label -> (lanes, runs, survivors, levels)) the mapping
    the kernel picks and the blocks and waves it makes on this card."""
    import ctypes
    from repro_torch.kernels import _build

    lib = _build.load_library(*rs.LIBRARY)
    occ_fn = lib.renewal_scan_occupancy
    occ_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    def occupancy(n: int, nf: int, per_run: int) -> tuple:
        blocks, threads, runs = (ctypes.c_int() for _ in range(3))
        _build.check_launch(lib, "renewal_scan", occ_fn(
            n, nf, per_run, blocks, threads, runs))
        return blocks.value, threads.value, runs.value

    def show(name: str, n: int, blocks: int, threads: int, runs: int) -> None:
        extra = {"survivors": n} if name == rs.RUN_KERNEL else {}
        line("occupancy", kernel=name, **extra, threads=threads,
             runs_per_block=runs, blocks_per_sm=blocks,
             warps_per_sm=blocks * threads // 32)

    for nf in (rs.FAST_MAX_F, rs.MAX_F):
        for n in list(range(1, rs.FAST_MAX_N + 1)) + [rs.GROUP_N]:
            for per_run in rs.lane_choices(n):
                if per_run > 1 or n <= rs.THROUGHPUT_MAX_N:
                    show(rs.kernel_name(n, nf, per_run), n,
                         *occupancy(n, nf, per_run))
    for n in RUN_OCCUPANCY_N:
        show(rs.RUN_KERNEL, n, *occupancy(n, rs.FAST_MAX_F, 1))
    for label, (lanes, n_runs, n, nf) in launches.items():
        per_run = renewal_lanes(rs, n, nf, lanes, n_runs)
        name = rs.kernel_name(n, nf, per_run)
        per_sm, threads, runs = occupancy(n, nf, per_run)
        grid = lanes * -(-n_runs // runs)
        line("occupancy", launch=label, kernel=name, lanes_per_run=per_run,
             blocks=grid, sms=sms, waves=f"{grid / (per_sm * sms):.3f}",
             warps_per_sm_first_wave=f"{min(grid / sms, per_sm) * threads / 32:.2f}")


def renewal_bound(args, out: dict, n_surv: int) -> tuple:
    """(bound_ms, bound_by, bytes, occurring decisions) of one renewal
    launch: each operand read once and each output written once at the
    card's memory rate, against the flop of each occurring (epoch,
    survivor) decision of this run's data on its ladder (args[2]: (P, 5,
    levels)) at the float32 rate."""
    n_bytes = sum(t.numel() * t.element_size() for t in args
                  if isinstance(t, torch.Tensor)) \
        + sum(t.numel() * t.element_size() for t in out.values())
    occurring = int(out["valid"].sum()) * n_surv
    flop = FLOP_PER_DECISION_BASE + FLOP_PER_LADDER_LEVEL * args[2].shape[2]
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = occurring * flop / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, occurring)


def with_shape(ops, n: int, nf: int):
    """Packed operands at ``n`` survivors and ``nf`` ladder levels: node
    columns taken in turn (a fourth survivor repeats the first); the first
    ``nf`` ladder levels, or past the ladder's F levels ``nf`` levels spaced
    evenly between its first and last by linear interpolation of every row
    (level 0 stays the reference)."""
    params, nodes, ladder = ops
    cols = [i % nodes.shape[2] for i in range(n)]
    f = ladder.shape[2]
    if nf <= f:
        lad = ladder[:, :, :nf]
    else:
        lad64 = ladder.double().cpu().numpy()
        pos = np.linspace(0.0, f - 1.0, nf)
        lad = torch.as_tensor(np.stack(
            [[np.interp(pos, np.arange(f), row) for row in lane]
             for lane in lad64]).astype(np.float32), device=ladder.device)
    return params, nodes[:, :, cols].contiguous(), lad.contiguous()


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


def flash_issued_ms(q, k, window) -> str:
    """The bf16 kernels' own ceiling: the products they issue (6 d per kept
    pair: Q K^T, then P V twice for P's hi and lo parts) at the card's
    bf16 rate; "n/a" in float32 (CUDA cores)."""
    if q.dtype != torch.bfloat16:
        return "n/a"
    return f"{1.5 * flash_work(q, k, window) / PEAK_BF16_FLOP_PER_S * 1e3:.5f}"


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


def flash_launch_timing(label: str, card_line: str, fa, args, kw, out,
                        plain_chunks: bool = False) -> dict:
    """A path's flash launch held within PLAIN_TOL of its plain version (run
    per KV head when ``plain_chunks``: the whole score tensor would not fit
    beside the model), then timed alone, against the plain version, with
    its bound.  Prints one [timing] line and returns its numbers."""
    q, k, v = args
    group, window = kw["group"], kw.get("window")
    if plain_chunks:
        def plain():
            return torch.cat([fa.flash_attention_reference(
                q[j * group:(j + 1) * group], k[j:j + 1], v[j:j + 1], **kw)
                for j in range(k.shape[0])])
    else:
        def plain():
            return fa.flash_attention_reference(q, k, v, **kw)
    err = check_close(f"{label} flash first launch", out, plain(),
                      *fa.PLAIN_TOL[out.dtype])
    fa_ms, fa_host = kernel_only_ms(
        lambda: fa.flash_attention_bhsd(*args, **kw), LM_KERNEL_REPS)
    plain_ms = statistics.median(cuda_ms(plain, reps=3, warmup=1))
    fa_bound, fa_by = bound(nbytes(q, k, v, out), flash_work(q, k, window),
                            q.dtype)
    issued = flash_issued_ms(q, k, window)
    rec = {"case": label, "shape": tuple(q.shape), "kv": tuple(k.shape),
           "group": group, "window": window, "max_abs_err": err,
           "kernel_ms": fa_ms, "plain_ms": plain_ms, "bound_ms": fa_bound,
           "bound_by": fa_by, "flop": flash_work(q, k, window)}
    line("timing", kernel="flash_attention", case=label, card=repr(card_line),
         shape=rec["shape"], kv=rec["kv"], group=group, window=window,
         kernel_ms=f"{fa_ms:.5f}", wrapper_host_ms=f"{fa_host:.5f}",
         plain_ms_median=f"{plain_ms:.3f}",
         plain_version="per KV head" if plain_chunks else "whole",
         bound_ms=f"{fa_bound:.5f}", bound_by=fa_by,
         issued_ceiling_ms=issued, flop=f"{rec['flop']:.4e}",
         bytes=nbytes(q, k, v, out),
         first_launch_max_abs_err=f"{err:.3e}")
    return rec


def sdpa_timing(label: str, card_line: str, args, kw, heads: int,
                out) -> float:
    """``scaled_dot_product_attention`` on a launch's operands: causal, or
    with the sliding window as a boolean mask.  A masked GQA call that has
    no backend here (or no memory) is timed with K/V expanded to every
    query head instead; the line says which call was timed."""
    q, k, v = args
    group, window = kw["group"], kw.get("window")
    b = q.shape[0] // heads
    q4 = q.view(b, heads, q.shape[1], q.shape[2])
    k4 = k.view(b, heads // group, k.shape[1], k.shape[2])
    v4 = v.view(b, heads // group, v.shape[1], v.shape[2])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        call = lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0,
                            enable_gqa=True)
        form = "is_causal, enable_gqa"
    else:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        call = lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=1.0,
                            enable_gqa=True)
        form = "masked call: boolean window mask, enable_gqa"
        try:
            call()
            torch.cuda.synchronize()
        except (torch.OutOfMemoryError, RuntimeError) as exc:
            torch.cuda.empty_cache()
            ke = k4.repeat_interleave(group, dim=1)
            ve = v4.repeat_interleave(group, dim=1)
            call = lambda: sdpa(q4, ke, ve, attn_mask=mask, scale=1.0)
            form = (f"masked call: boolean window mask, K/V expanded to "
                    f"{heads} heads ({type(exc).__name__} with enable_gqa: "
                    f"{str(exc).splitlines()[0][:80]!r})")
    diff = float((call().reshape(out.shape).float() - out.float()).abs().max())
    ms, _ = kernel_only_ms(call, LM_KERNEL_REPS)
    line("timing", kernel="sdpa", case=label, card=repr(card_line),
         call=repr(form), sdpa_ms=f"{ms:.5f}",
         sdpa_vs_kernel_max_abs=f"{diff:.3e}")
    return ms


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

    from repro_torch import spans

    from repro_torch.kernels.flash_attention import KERNEL_NAMES
    from repro_torch.kernels.ssd_scan import KERNEL_NAMES as SSD_KERNELS

    torch.cuda.synchronize()
    # spans off: their ranges' shadows on the device are no kernels
    with spans.off(), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes = {"flash_attention": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
               "other": 0.0}
    # the SSD scan's kernels: three per bf16 call, one per float32 call;
    # the kernels that ran each part, as the profiler names them
    ssd_parts = {part: 0.0 for part in SSD_PARTS}
    ssd_names = {part: set() for part in SSD_PARTS}
    kernels, n_launch = [], 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        n_launch += ev.count
        kernels.append((ms, ev.key[:60], ev.count))
        name = ev.key.lower()
        if any(n in name for n in KERNEL_NAMES):
            classes["flash_attention"] += ms
        elif any(n in name for n in SSD_KERNELS):
            classes["ssd_scan"] += ms
            part = SSD_KERNELS[next(n for n in SSD_KERNELS if n in name)]
            ssd_parts[part] += ms
            found = re.search(r"ssd_\w+(<[^>]*>)?", ev.key)
            ssd_names[part].add(found.group(0).replace(" ", "") if found
                                else ev.key[:60])
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    device_ms = sum(classes.values())
    if device_ms == 0.0:
        return {"wall_ms": wall_ms, "device_ms": None}
    return {"wall_ms": wall_ms, "device_ms": device_ms, "launches": n_launch,
            "busy_share": device_ms / wall_ms, "classes": classes,
            "ssd_parts": ssd_parts,
            "ssd_kernels": {p: sorted(v) for p, v in ssd_names.items() if v},
            "top": sorted(kernels, reverse=True)[:8]}


def print_profile(phase: str, card_line: str, prof: dict) -> None:
    if prof["device_ms"] is None:
        line(phase, card=repr(card_line), wall_ms=f"{prof['wall_ms']:.3f}",
             device_time="not measured (the trace holds no device time)")
        return
    line(phase, card=repr(card_line), wall_ms=f"{prof['wall_ms']:.3f}",
         device_ms=f"{prof['device_ms']:.3f}", kernel_launches=prof["launches"],
         busy_share=f"{prof['busy_share']:.4f}",
         **{f"{k}_ms": f"{v:.3f}" for k, v in prof["classes"].items()},
         **{f"ssd_{k}_ms": f"{v:.3f}" for k, v in prof["ssd_parts"].items()},
         **{f"ssd_{k}_kernel": "+".join(v) for k, v in prof["ssd_kernels"].items()})
    for ms, name, count in prof["top"]:
        line(phase, kernel=repr(name), count=count, device_ms=f"{ms:.3f}")


def tables_equal_cpu(card_line: str, head_dim: int) -> None:
    """The models' constant tables on the card against their CPU values,
    bit for bit: RoPE's inverse frequencies at zamba2-7b's head_dim and
    whisper-medium's 1500 x 1024 sinusoids (ROADMAP.md Queue 3, item 17)."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, layers

    theta = get_config(LM_ARCH).rope_theta
    whisper = get_config("whisper-medium")
    length = whisper.encdec.enc_len
    for name, fn, args in (
            ("rope_frequencies", layers.rope_frequencies, (head_dim, theta)),
            ("_sinusoids", encdec._sinusoids, (length, whisper.d_model))):
        got, want = fn(*args, device=torch.device("cuda")), fn(*args)
        differ = int((got.cpu().view(torch.int32) != want.view(torch.int32)).sum())
        line("card-vs-cpu", table=name, args=args, entries=want.numel(),
             differing=differ, card=repr(card_line))
        if got.device.type != "cuda" or differ:
            raise Failed(f"{name}{args} on the card differs from the CPU at "
                         f"{differ} entries")


def lm_path(card_line: str, fa, ssd) -> list:
    """Phases 6-10: the Zamba2-7B serving path in the registry's layout.
    Returns the kernel records of flash_attention and ssd_scan."""
    from repro_torch import spans
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
    check_flash_tiles(fa)
    tables_equal_cpu(card_line, hd)

    # --- phase 6: kernels against their plain versions on the card ---------
    # (label, batch, heads, kv heads, Sq, head dim, dtype, window, Sk)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("zamba2-prefill", PREFILL_BATCH, heads, heads, PREFILL_LEN, hd,
              bf16, None, None),
             ("ragged-4000", PREFILL_BATCH, heads, heads, 4000, hd, bf16,
              None, None),
             ("sq129", 1, 4, 4, 129, hd, bf16, None, None),
             ("gqa-window", 2, 4, 1, 256, 64, f32, 128, None),
             ("gqa-window-in-tile-bf16", 2, 4, 1, 384, 64, bf16, 100, None),
             ("gqa-window-nonpow2", 1, 6, 2, 384, 64, f32, 256, None),
             ("suffix-200-of-1000-bf16", 1, 4, 2, 200, hd, bf16, None, 1000),
             ("float32-d128", 1, 8, 2, 1000, 128, f32, None, None),
             ("bf16-d16", 1, 4, 2, 512, 16, bf16, None, None),
             ("bf16-d224", 1, 4, 4, 1000, 224, bf16, None, None),
             ("bf16-d256", 1, 4, 2, 512, 256, bf16, None, None)]
    for i, (label, b, h, kh, s, d, dtype, win, sk) in enumerate(cases):
        q, k, v = flash_operands(b, h, kh, s, d, dtype, 100 + i, dev, sk)
        worst["flash_attention"] = max(worst["flash_attention"],
                                       flash_vs_plain(fa, label, q, k, v,
                                                      h // kh, win))
    # (label, dtype, batch, heads, groups, S, chunk, P, N); zamba2-prefill
    # passes the state along 224 chains of 16 chunks, chunk-13 is a
    # 13-token prompt (ops.ssd_scan takes min(chunk, S)); mamba2-370m's
    # (P, N) = (64, 128) at its 32 heads; chunks 13, 48, 100 and 192 end
    # inside a 64-row tile, 512 is past the wgmma kernels' chunks.  The
    # fused chunk state's chain: chain-63 is one (batch, head) of 64 chunks
    # (63 links, one after another); units-3584 at chunk 100 holds 3,584
    # units, 13.6 times the 264 blocks resident at once
    q_cfg, p_cfg, n_cfg = s_cfg.chunk_size, s_cfg.head_dim, s_cfg.state_dim
    ssd_cases = (
        ("zamba2-prefill", bf16, PREFILL_BATCH, ssm_heads, 1, PREFILL_LEN, q_cfg,
         p_cfg, n_cfg),
        ("zamba2-float32", f32, PREFILL_BATCH, ssm_heads, 1, PREFILL_LEN, q_cfg,
         p_cfg, n_cfg),
        ("groups-4", bf16, PREFILL_BATCH, 8, 4, 1024, q_cfg, p_cfg, n_cfg),
        ("chunk-13", bf16, 1, 8, 1, 13, 13, p_cfg, n_cfg),
        ("chunk-48", bf16, PREFILL_BATCH, 8, 1, 96, 48, p_cfg, n_cfg),
        ("pn-64x128", bf16, PREFILL_BATCH, 32, 1, PREFILL_LEN, 256, 64, 128),
        ("chunk-100", bf16, PREFILL_BATCH, 8, 1, 400, 100, p_cfg, n_cfg),
        ("chunk-192-pn-64x128", bf16, PREFILL_BATCH, 8, 4, 768, 192, 64, 128),
        ("chunk-512", bf16, PREFILL_BATCH, 8, 1, 2048, 512, p_cfg, n_cfg),
        ("chain-63", bf16, 1, 1, 1, 64 * q_cfg, q_cfg, p_cfg, n_cfg),
        ("units-3584", bf16, PREFILL_BATCH, ssm_heads, 1, 1600, 100, p_cfg, n_cfg))
    check_ssd_tiles(ssd, [(p, n, chunk) for _, dtype, *_, chunk, p, n in ssd_cases
                          if dtype == bf16])
    for i, (label, dtype, b, h, g, s, chunk, p, n) in enumerate(ssd_cases):
        ops_ = ssd_operands(b, h, g, s, p, n, dtype, 200 + i, dev)
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
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap_fa, \
            recorded(ops, "ssd_scan_bhsp", first_call) as cap_ssd:
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
         bound_by=fa_by, issued_ceiling_ms=flash_issued_ms(q, k, window),
         flop=f"{flash_work(q, k, window):.4e}", bytes=nbytes(q, k, v, fa_out))
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
         wall_ms_median=f"{wall_ms:.3f}",
         flash_ms_x13=f"{n_super * fa_ms:.3f}",
         ssd_ms_x81=f"{cfg.num_layers * ssd_ms:.3f}",
         rest_ms=f"{wall_ms - kernels_ms:.3f}",
         tokens_per_s=f"{PREFILL_BATCH * PREFILL_LEN / (wall_ms * 1e-3):.1f}")
    del cap_fa, cap_ssd, fa_args, ssd_args, fa_out, ssd_y, ssd_st, q, k, v
    del q4, k4, v4
    prof = device_profile(lambda: prefill(params, batch))
    print_profile("prefill-profile", card_line, prof)
    # the 81 launches ran the wgmma chunk state and chunk scan, and no
    # state-passing kernel
    p_cfg, n_cfg, q_cfg = s_cfg.head_dim, s_cfg.state_dim, s_cfg.chunk_size
    want = {"chunk_state": [f"{ssd.chunk_state_kernel(p_cfg, n_cfg, q_cfg)}<{p_cfg},{n_cfg}>"],
            "chunk_scan": [f"{ssd.chunk_scan_kernel(p_cfg, n_cfg, q_cfg)}<{p_cfg},{n_cfg}>"]}
    if prof["device_ms"] is not None and prof["ssd_kernels"] != want:
        raise Failed(f"the prefill's SSD kernels were {prof['ssd_kernels']}, "
                     f"expected {want}")

    # --- phase 9 (run here, on the bf16 weights): the serve loop -----------
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    spans.reset_counts()
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
    free_cuda()

    # --- phase 8: float32 prefill against decode and the plain path --------
    cfg32 = get_config(LM_ARCH, use_flash_kernel=True, dtype="float32",
                       num_layers=DECODE_CHECK_LAYERS)
    n_super32 = cfg32.num_layers // cfg32.hybrid.shared_every
    model = build_model(cfg32, device="cuda")
    params = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, DECODE_CHECK_LEN)), device=dev)
    spans.reset_counts()
    # the hidden state after each Mamba2 layer, at the last position
    last_pos = lambda i, args, kw, x: x[:, -1].float().clone()
    with recorded(transformer, "_ssm_block", last_pos) as pre_layers:
        last = make_prefill_step(model)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"]) != \
            (n_super32, cfg32.num_layers):
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
    every = cfg32.hybrid.shared_every
    marks = [every * i + every - 1 for i in range(n_super32)] \
        + [cfg32.num_layers - 1]
    per_block = [float((pre_layers[i] - dec_layers[i]).abs().max()
                       / pre_layers[i].abs().max()) for i in marks]
    argmax_equal = bool(torch.equal(last.argmax(-1), dec_last.argmax(-1)))
    err = (dec_last.double() - last.double()).abs()
    line("prefill-vs-decode", arch=LM_ARCH, dtype="float32",
         layers=cfg32.num_layers, tokens=DECODE_CHECK_LEN, batch=PREFILL_BATCH,
         max_abs_err=f"{float(err.max()):.3e}",
         logits_absmax=f"{float(last.abs().max()):.4f}",
         argmax_equal=argmax_equal, decode_s=f"{decode_s:.2f}",
         kernel_vs_plain_max_abs=f"{err_plain:.3e}",
         per_superblock_rel=[f"{e:.2e}" for e in per_block])
    check_close("float32 decode vs prefill logits", dec_last, last, *TOL_DECODE)
    if not argmax_equal:
        raise Failed("float32 decode and prefill disagree on the argmax")
    del model, plain, params, cache, last, last_plain, dec_logits
    free_cuda()

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


def published_zamba2_phase(card_line: str, fa, ssd) -> dict:
    """Zamba2-7B at its published layout and widths
    (``zamba2_7b.published_config()``: 81 Mamba2 layers at 2 groups, two
    shared blocks by turns at 13 layers, 32 heads of 224), bf16, 2 x 4096
    tokens through ``make_prefill_step``.  Requires one flash launch per
    shared-block call and one SSD, one gated-norm and one causal-conv
    launch per layer, and one RMSNorm launch per norm,
    holds the first flash and SSD launches
    against its plain version on the operands the path gave it, and times
    it alone with its bound.  Returns those numbers by kernel name."""
    from repro_torch import spans
    from repro_torch.configs import zamba2_7b
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import gate_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = dataclasses.replace(zamba2_7b.published_config(),
                              use_flash_kernel=True)
    heads, n_calls = cfg.hybrid.shared_num_heads, len(cfg.hybrid.layer_ids)
    head_dim = 2 * cfg.d_model // heads
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)), device=dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap_fa, \
            recorded(ops, "ssd_scan_bhsp", first_call) as cap_ssd:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_scan": ssd.LAUNCHES["ssd_scan"],
                "gate_norm": gn.LAUNCHES["gate_norm"],
                "causal_conv": cc.LAUNCHES["causal_conv"],
                "rms_norm": rn.LAUNCHES["rms_norm"]}
    expect = {"flash_attention": n_calls, "ssd_scan": cfg.num_layers,
              "gate_norm": cfg.num_layers, "causal_conv": cfg.num_layers,
              "rms_norm": cfg.num_layers + 2 * n_calls + 1}
    if launches != expect:
        raise Failed(f"published prefill launched {launches}, expected {expect}")
    if (len(cap_fa), len(cap_ssd)) != (n_calls, cfg.num_layers):
        raise Failed("published prefill: kernel calls and launches disagree")
    if last.shape != (PREFILL_BATCH, cfg.padded_vocab_size) or \
            not torch.isfinite(last).all():
        raise Failed(f"published prefill logits: shape {tuple(last.shape)} "
                     f"or non-finite")
    del last
    _, wall_ms = wall_ms_median(lambda: prefill(params, batch), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fa_args, fa_kw, fa_out = cap_fa[0]
    ssd_args, ssd_kw, (ssd_y, ssd_st) = cap_ssd[0]
    want_fa = (PREFILL_BATCH * heads, PREFILL_LEN, head_dim)
    if tuple(fa_args[0].shape) != want_fa or ssd_args[3].shape[1] != cfg.ssm.n_groups:
        raise Failed(f"published prefill operands: flash {tuple(fa_args[0].shape)}"
                     f" (expected {want_fa}), SSD B {tuple(ssd_args[3].shape)}"
                     f" (expected {cfg.ssm.n_groups} groups)")
    line("published-prefill", arch=cfg.name, card=repr(card_line),
         params=n_params, dtype=cfg.dtype, batch=PREFILL_BATCH,
         tokens=PREFILL_LEN, launches=json.dumps(launches),
         wall_ms_median=f"{wall_ms:.3f}",
         tokens_per_s=f"{PREFILL_BATCH * PREFILL_LEN / (wall_ms * 1e-3):.1f}",
         peak_gb=f"{peak_gb:.3f}")
    del cap_fa, cap_ssd, model, params, prefill, batch, tokens
    free_cuda()

    rec_fa = flash_launch_timing("zamba2-published", card_line, fa, fa_args,
                                 fa_kw, fa_out)
    y_p, st_p = ssd.ssd_scan_reference(*ssd_args, **ssd_kw)
    err_ssd = max(check_close("published ssd first launch y", ssd_y, y_p, *TOL_SSD),
                  check_close("published ssd first launch state", ssd_st, st_p,
                              *TOL_SSD))
    del y_p, st_p
    ssd_ms, ssd_host = kernel_only_ms(
        lambda: ssd.ssd_scan_bhsp(*ssd_args, **ssd_kw), LM_KERNEL_REPS)
    ssd_plain_ms = statistics.median(cuda_ms(
        lambda: ssd.ssd_scan_reference(*ssd_args, **ssd_kw), reps=3, warmup=1))
    work = ssd_work(ssd_args[0], ssd_args[3], ssd_kw["chunk"])
    ssd_bound, ssd_by = bound(nbytes(*ssd_args, ssd_y, ssd_st), work,
                              ssd_args[0].dtype)
    rec_ssd = {"case": "zamba2-published", "x": tuple(ssd_args[0].shape),
               "bc": tuple(ssd_args[3].shape), "chunk": ssd_kw["chunk"],
               "max_abs_err": err_ssd, "kernel_ms": ssd_ms,
               "plain_ms": ssd_plain_ms, "bound_ms": ssd_bound,
               "bound_by": ssd_by, "flop": work}
    line("timing", kernel="ssd_scan", case="zamba2-published",
         card=repr(card_line), x=rec_ssd["x"], bc=rec_ssd["bc"],
         chunk=rec_ssd["chunk"], kernel_ms=f"{ssd_ms:.5f}",
         wrapper_host_ms=f"{ssd_host:.5f}", plain_ms_median=f"{ssd_plain_ms:.3f}",
         bound_ms=f"{ssd_bound:.5f}", bound_by=ssd_by, flop=f"{work:.4e}",
         bytes=nbytes(*ssd_args, ssd_y, ssd_st),
         first_launch_max_abs_err=f"{err_ssd:.3e}")
    del fa_args, fa_out, ssd_args, ssd_y, ssd_st
    free_cuda()
    rec_fa["launches"], rec_ssd["launches"] = n_calls, cfg.num_layers
    return {"flash_attention": rec_fa, "ssd_scan": rec_ssd}


# the SSM cells' gated norms: (cell, batch, tokens, heads, head dim, groups,
# state); the benchmark's mamba2-2.7b.prefill-16x4096 and
# zamba2-7b.prefill-2x4096
GATE_NORM_CASES = (("mamba2-2.7b", 16, 4096, 80, 64, 1, 128),
                   ("zamba2-7b", 2, 4096, 112, 64, 2, 64))


def gate_norm_phase(card_line: str) -> None:
    """``[gate-norm]``: the mixer's gated-norm kernel at both SSM cells'
    shapes, on operands laid out as ``ssm_mixer`` holds them (y the
    transposed view of a (B, H, S, P) float32 buffer, x and z column slices
    of the conv's and the in projection's outputs), held to its plain
    version at flash's ``PLAIN_TOL``, timed alone beside the plain chain and
    its byte bound (y float32, x, z and the output bf16, each once)."""
    from repro_torch import spans
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gate_norm as gn
    from repro_torch.kernels import ops

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    for label, b, s, h, p, g, n in GATE_NORM_CASES:
        d_in = h * p
        gen = torch.Generator(device=dev).manual_seed(31)
        rand = lambda *shape: torch.randn(shape, device=dev, generator=gen)
        y = rand(b, h, s, p).transpose(1, 2)
        x = rand(b, s, d_in + 2 * g * n).to(bf16)[..., :d_in].reshape(b, s, h, p)
        z = (2 * rand(b, s, 2 * d_in + 2 * g * n + h)).to(bf16)[..., :d_in]
        d, w = rand(h), (0.1 * rand(d_in)).to(bf16)
        args = (y, x, d, z, w, g, 1e-5)
        spans.reset_counts()
        got = ops.gated_norm_skip(*args)
        torch.cuda.synchronize()
        if gn.LAUNCHES["gate_norm"] != 1:
            raise Failed(f"gate-norm {label}: {gn.LAUNCHES} launches, expected 1")
        err = check_close(f"gate-norm {label}", got, gn.gate_norm_reference(*args),
                          *fa.PLAIN_TOL[bf16])
        del got
        free_cuda()
        k_ms, host_ms = kernel_only_ms(lambda: ops.gated_norm_skip(*args),
                                       LM_KERNEL_REPS)
        plain_ms = statistics.median(cuda_ms(
            lambda: gn.gate_norm_reference(*args), reps=3, warmup=1))
        n_bytes = b * s * d_in * (4 + 2 + 2 + 2) + nbytes(d, w)
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        line("gate-norm", cell=label, card=repr(card_line), batch=b, tokens=s,
             heads=h, head_dim=p, groups=g, kernel_ms=f"{k_ms:.5f}",
             wrapper_host_ms=f"{host_ms:.5f}", plain_ms_median=f"{plain_ms:.3f}",
             bytes=n_bytes, bound_ms=f"{bound_ms:.5f}", bound_by="bytes",
             bound_share=f"{bound_ms / k_ms:.4f}", max_abs_err=f"{err:.3e}")
        del y, x, z, d, w, args
        free_cuda()


# the SSM cells' causal convs: (cell, batch, tokens, d_inner, channels, the
# in projection's row); the benchmark's mamba2-2.7b.prefill-16x4096 and
# zamba2-7b.prefill-2x4096
CAUSAL_CONV_CASES = (("mamba2-2.7b", 16, 4096, 5120, 5376, 10576),
                     ("zamba2-7b", 2, 4096, 7168, 7424, 14704))


def causal_conv_phase(card_line: str) -> None:
    """``[causal-conv]``: the mixer's causal-conv kernel at both SSM cells'
    shapes, x the xBC column slice of an in projection's output as
    ``ssm_mixer`` holds it, held bit for bit to its plain version, timed
    alone beside the plain chain, ``F.conv1d(groups=C)`` + SiLU (the one-call
    PyTorch equivalent) and its byte bound (x and the output bf16, once)."""
    import torch.nn.functional as F

    from repro_torch import spans
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import ops

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    for label, b, s, d_in, c, row in CAUSAL_CONV_CASES:
        gen = torch.Generator(device=dev).manual_seed(33)
        rand = lambda *shape: torch.randn(shape, device=dev, generator=gen)
        x = rand(b, s, row).to(bf16)[..., d_in:d_in + c]
        w, bias = (0.5 * rand(4, c)).to(bf16), (0.1 * rand(c)).to(bf16)
        spans.reset_counts()
        got = ops.causal_conv(x, w, bias)
        torch.cuda.synchronize()
        if cc.LAUNCHES["causal_conv"] != 1:
            raise Failed(f"causal-conv {label}: {cc.LAUNCHES} launches, expected 1")
        want = cc.causal_conv_reference(x, w, bias)
        n_diff = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        if n_diff:
            raise Failed(f"causal-conv {label}: {n_diff} outputs differ from "
                         f"the plain chain's bits")
        del got, want
        free_cuda()
        taps = w.t().unsqueeze(1).contiguous()
        k_ms, host_ms = kernel_only_ms(lambda: ops.causal_conv(x, w, bias),
                                       LM_KERNEL_REPS)
        plain_ms = statistics.median(cuda_ms(
            lambda: cc.causal_conv_reference(x, w, bias), reps=3, warmup=1))
        conv1d_ms = statistics.median(cuda_ms(
            lambda: F.silu(F.conv1d(x.transpose(1, 2), taps, bias, padding=3,
                                    groups=c)[..., :s]), reps=3, warmup=1))
        n_bytes = 2 * b * s * c * 2 + nbytes(w, bias)
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        line("causal-conv", cell=label, card=repr(card_line), batch=b, tokens=s,
             channels=c, row=row, kernel_ms=f"{k_ms:.5f}",
             wrapper_host_ms=f"{host_ms:.5f}", plain_ms_median=f"{plain_ms:.3f}",
             conv1d_silu_ms_median=f"{conv1d_ms:.3f}", bytes=n_bytes,
             bound_ms=f"{bound_ms:.5f}", bound_by="bytes",
             bound_share=f"{bound_ms / k_ms:.4f}", bits_differing=n_diff)
        del x, w, bias, taps
        free_cuda()


# the cells' RMSNorms: (cell, rows, width); the block and final norms of
# mamba2-2.7b.prefill-16x4096, zamba2-7b.prefill-2x4096 (and its shared
# blocks' norm over concat([x, e])), olmoe-1b-7b.prefill-2x4096 (its
# QK-norms too) and mixtral-8x22b.prefill-2x8192
RMS_NORM_CASES = (("mamba2-2.7b", 65536, 2560), ("zamba2-7b", 8192, 3584),
                  ("zamba2-7b-concat", 8192, 7168), ("olmoe-1b-7b", 8192, 2048),
                  ("mixtral-8x22b", 16384, 6144))
# inputs a timing cycles through, at least: more than the card's 50 MB of L2
RMS_NORM_INPUT_BYTES = 200_000_000


def rms_norm_phase(card_line: str) -> None:
    """``[rms-norm]``: the RMSNorm kernel at each cell's norm shape in bf16,
    held to the plain chain (``layers.rms_norm``) at flash's ``PLAIN_TOL``
    with the share of outputs not bit-equal, timed alone over copies of the
    input that together exceed L2 (each launch reads its x from device
    memory, as the byte bound assumes), beside the plain chain,
    ``F.rms_norm(x, (D,), 1 + w, eps)`` (the one-call PyTorch equivalent, on
    ``1 + w`` made once) and its byte bound (x and the output once)."""
    import itertools

    import torch.nn.functional as F

    from repro_torch import spans
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import layers

    dev, bf16, eps = torch.device("cuda"), torch.bfloat16, 1e-5
    for label, rows, d in RMS_NORM_CASES:
        gen = torch.Generator(device=dev).manual_seed(35)
        copies = -(-RMS_NORM_INPUT_BYTES // (rows * d * 2))
        xs = [(3 * torch.randn((rows, d), device=dev, generator=gen)).to(bf16)
              for _ in range(copies)]
        w = (0.1 * torch.randn((d,), device=dev, generator=gen)).to(bf16)
        spans.reset_counts()
        got = ops.rms_norm(xs[0], w, eps)
        torch.cuda.synchronize()
        if rn.LAUNCHES["rms_norm"] != 1:
            raise Failed(f"rms-norm {label}: {rn.LAUNCHES} launches, expected 1")
        want = layers.rms_norm(xs[0], w, eps)
        err = check_close(f"rms-norm {label}", got, want, *fa.PLAIN_TOL[bf16])
        differing = float((got != want).float().mean())
        del got, want
        free_cuda()
        turn = itertools.cycle(xs)
        k_ms, host_ms = kernel_only_ms(lambda: ops.rms_norm(next(turn), w, eps),
                                       LM_KERNEL_REPS)
        plain_ms = statistics.median(cuda_ms(
            lambda: layers.rms_norm(next(turn), w, eps), reps=5, warmup=1))
        w1 = 1 + w
        lib_ms = statistics.median(cuda_ms(
            lambda: F.rms_norm(next(turn), (d,), w1, eps), reps=5, warmup=1))
        n_bytes = 2 * rows * d * 2 + nbytes(w)
        bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        line("rms-norm", cell=label, card=repr(card_line), rows=rows, width=d,
             kernel_ms=f"{k_ms:.5f}", wrapper_host_ms=f"{host_ms:.5f}",
             plain_ms_median=f"{plain_ms:.4f}",
             f_rms_norm_ms_median=f"{lib_ms:.4f}", bytes=n_bytes,
             bound_ms=f"{bound_ms:.5f}", bound_by="bytes",
             bound_share=f"{bound_ms / k_ms:.4f}", input_copies=copies,
             max_abs_err=f"{err:.3e}", share_not_bit_equal=f"{differing:.3e}")
        del xs, w, w1, turn
        free_cuda()


# ---------------------------------------------------------------------------
# the operator stack: policy optimisation, the fleet advisor, campaigns
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stage_clock(parts):
    """Stands in for each ``(label, module, name)`` function while a call
    runs, synchronising around every call of it: yields ``{label: [ms,
    calls]}``, the host milliseconds spent inside each part."""
    acc = {label: [0.0, 0] for label, _, _ in parts}
    saved = []
    for label, module, name in parts:
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def wrapped(*args, _fn=fn, _cell=acc[label], **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            _cell[0] += (time.perf_counter() - t0) * 1e3
            _cell[1] += 1
            return out

        setattr(module, name, wrapped)
    try:
        yield acc
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def entry_point_timing(fn, reps: int, parts=()) -> dict:
    """Wall milliseconds of an entry point (median of ``reps`` calls after
    a warm one); then one call under ``torch.profiler`` for its CUDA
    launches and device busy share, with the renewal kernel's launches
    counted; then one call with ``parts`` (and the float64 scan,
    ``sweep._renewal_scan``) clocked, for each part's share of that
    call's wall time."""
    from repro_torch import spans
    from repro_torch.core import sweep
    from repro_torch.kernels import renewal_scan as rs

    _, ms = wall_ms_median(fn, reps)
    spans.reset_counts()
    prof = device_profile(fn)
    measured = prof["device_ms"] is not None
    out = {"wall_ms_median": f"{ms:.3f}",
           "device_launches": prof["launches"] if measured else "not measured",
           "busy_share": (f"{prof['busy_share']:.4f}" if measured
                          else "not measured"),
           "renewal_scan_launches": rs.LAUNCHES["renewal_scan"]}
    with stage_clock((("scan", sweep, "_renewal_scan"),) + tuple(parts)) as acc:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        clocked_ms = (time.perf_counter() - t0) * 1e3
    out["clocked_wall_ms"] = f"{clocked_ms:.3f}"
    for label, (part_ms, calls) in acc.items():
        out[f"{label}_ms"] = f"{part_ms:.3f}"
        out[f"{label}_calls"] = calls
        out[f"{label}_share"] = f"{part_ms / clocked_ms:.4f}"
    return out


def rows_equal(got, want, fields=("energy_ref", "energy_int", "saving",
                                  "end_time", "n_failures",
                                  "mean_energy_j", "mean_makespan_s")) -> bool:
    return all(np.array_equal(getattr(got, f), getattr(want, f))
               for f in fields)


def optimize_phase(card_line: str, rs, sweep, optimize, grid_cfg, table,
                   makespans, key) -> tuple:
    """``[optimize]``: the operator entry points on the reference
    benchmark's problem (the 4 h-rendezvous workload, the 42-policy table,
    2 d of work, 8 h MTBF) at the policy grid's 4096 runs x 64 epochs: the
    grid stage on the scan and as one renewal_scan launch, each spot-checked
    lane bit-equal to a standalone ``renewal_monte_carlo_device`` call on
    the card, the kernel grid within TOL_ORACLE of the scan's (tied
    intervals as in ``[renewal-f64]``); CEM at its defaults on the scan,
    monotone and no worse than its seed; the process panel at equal MTBF.
    Returns the kernel launch's (max_abs_err, max_rel_err) against its
    plain version."""
    from repro_torch.core.scenarios import apply_policy

    kw = dict(table=table, work_s=GRID_WORK_S, mtbf_s=GRID_MTBF_S,
              n_runs=FULL_RUNS, max_failures=FULL_EPOCHS)
    scan = optimize.optimize_policy(grid_cfg, key, **kw)
    kern, launches, (call,) = drive(
        rs, lambda: optimize.optimize_policy(grid_cfg, key, engine="kernel",
                                             **kw))
    if launches != 1:
        raise Failed(f"optimize: {launches} renewal_scan launches in the "
                     "kernel grid stage, expected 1")
    k_abs, k_rel = compare_outputs(
        call[2], rs.renewal_scan_reference(*call[0], **call[1]))
    spot = (0, 13, 28, len(table) - 1)
    for engine, opt in (("scan", scan), ("kernel", kern)):
        for p in spot:
            st = sweep.renewal_monte_carlo_device(
                apply_policy(grid_cfg, **table.policy(p)), key,
                n_runs=FULL_RUNS, max_failures=FULL_EPOCHS,
                makespan_s=float(makespans[p]), mtbf_s=GRID_MTBF_S,
                stats=True, engine=engine, device="cuda")
            for f in ("energy_ref", "energy_int", "end_time", "n_failures"):
                if not np.array_equal(getattr(st, f)[0].cpu().numpy(),
                                      getattr(opt.grid, f)[p]):
                    raise Failed(f"optimize {engine}: policy {p} {f} differs "
                                 "from a standalone call")
    rel = np.abs(kern.grid.mean_energy_j / scan.grid.mean_energy_j - 1)
    tie = np.isin(np.round(table.ckpt_interval, 6), KERNEL_TIE_INTERVALS_S)
    if rel[~tie].max() > TOL_ORACLE:
        raise Failed(f"optimize: kernel grid means {rel[~tie].max():.3e} "
                     f"from the scan's > {TOL_ORACLE}")
    for engine, opt in (("scan", scan), ("kernel", kern)):
        line("optimize", stage="grid", engine=engine, card=repr(card_line),
             policies=len(table), runs=FULL_RUNS, epochs=FULL_EPOCHS,
             best=opt.grid.best, knee_interval=opt.knee["ckpt_interval"],
             pareto=len(opt.pareto),
             best_mean_energy_j=f"{opt.best['mean_energy_j']:.6e}",
             lanes_bit_equal_to_standalone="/".join(map(str, spot)),
             **entry_point_timing(lambda e=engine: optimize.optimize_policy(
                 grid_cfg, key, engine=e, **kw), reps=3))
    line("optimize", check="kernel grid vs scan grid", launches=launches,
         kernel_vs_plain="ints exact", max_abs_err=f"{k_abs:.6g}",
         max_mean_rel_untied=f"{rel[~tie].max():.3e}",
         max_mean_rel_tied=f"{rel[tie].max():.3e}", bar=TOL_ORACLE)

    refined = optimize.optimize_policy(grid_cfg, key, refine=True, **kw)
    scores = [h["best_score"] for h in refined.cem.iterations]
    if any(b > a for a, b in zip(scores, scores[1:])):
        raise Failed(f"optimize: CEM best scores not monotone: {scores}")
    if refined.best["mean_energy_j"] > scan.best["mean_energy_j"]:
        raise Failed("optimize: CEM ends worse than its seed")
    line("optimize", stage="cem", engine="scan", card=repr(card_line),
         iterations=len(scores), population=24,
         evaluations=refined.cem.n_evaluations,
         seed_interval=scan.best["ckpt_interval"],
         best_interval=f"{refined.best['ckpt_interval']:.3f}",
         best_mu1=f"{refined.best['mu1']:.4f}",
         seed_mean_energy_j=f"{scan.best['mean_energy_j']:.6e}",
         best_mean_energy_j=f"{refined.best['mean_energy_j']:.6e}",
         monotone=True,
         **entry_point_timing(lambda: optimize.optimize_policy(
             grid_cfg, key, refine=True, **kw), reps=2))

    panel_call = lambda: optimize.optimize_across_processes(
        grid_cfg, key, **kw)
    panel = panel_call()
    for name, opt in panel.items():
        if not np.all(np.isfinite(opt.grid.mean_energy_j)):
            raise Failed(f"optimize panel {name}: non-finite energies")
        line("optimize", stage="panel", process=name,
             label=repr(opt.process_label), best=opt.grid.best,
             best_interval=opt.best["ckpt_interval"],
             mean_failures=f"{opt.grid.mean_failures.mean():.4f}",
             best_mean_energy_j=f"{opt.best['mean_energy_j']:.6e}")
    line("optimize", stage="panel", card=repr(card_line),
         processes=len(panel), **entry_point_timing(panel_call, reps=2))
    return k_abs, k_rel


def fleet_phase(card_line: str, rs, sweep, optimize, fleet, key) -> None:
    """``[fleet]``: the reference benchmark's fleet (256 exponential
    clusters of 4 nodes, one bucket) and the mixed fleet (4 and 8 nodes,
    half Weibull: four buckets), 14 policies, 32 runs x 16 failures.  Holds
    8 clusters of each bit-equal to standalone ``optimize_policy`` calls on
    the card, padding inert, submit order, cache hits with no new traces on
    a second ``advise``, ``shard=True`` equal to the unsharded path; times
    the batched advisor against the per-cluster loop."""
    from repro_torch import spans

    table = optimize.policy_grid(
        ckpt_interval=np.geomspace(2400.0, 19200.0, 7), mu1=[6.0],
        wait_mode=[0, 1])
    kw = dict(n_runs=FLEET_RUNS, max_failures=FLEET_FAILURES)
    advisor_of = lambda **a: fleet.FleetAdvisor(table, key=key, device="cuda",
                                                **kw, **a)
    for label, profiles in (
            ("single-bucket", fleet.synthetic_fleet(
                FLEET_CLUSTERS, seed=0, node_buckets=(4,), weibull_frac=0.0)),
            ("mixed", fleet.synthetic_fleet(FLEET_CLUSTERS, seed=0))):
        advisor = advisor_of()
        spans.reset_counts()
        out = advisor.advise(profiles)
        if rs.LAUNCHES["renewal_scan"]:
            raise Failed("fleet: the cluster axis launched renewal_scan")
        first = advisor.cache_stats()
        again = advisor.advise(profiles)
        second = advisor.cache_stats()
        n_buckets = len({p.bucket_key() for p in profiles})
        if (second.traces != first.traces
                or second.hits != first.hits + n_buckets
                or first.misses != n_buckets):
            raise Failed(f"fleet {label}: cache {first} then {second}")
        picks = np.linspace(0, len(profiles) - 1, 8).round().astype(int)
        for c in picks:
            p = profiles[c]
            solo = optimize.optimize_policy(
                p.scenario(), key, table=table, process=p.failure_process(),
                work_s=p.work_s, device="cuda", **kw)
            if not (rows_equal(out[c].optimum.grid, solo.grid)
                    and out[c].best == solo.best and out[c].knee == solo.knee):
                raise Failed(f"fleet {label}: cluster {c} differs from a "
                             "standalone optimize_policy call")
        if not all(rows_equal(a.optimum.grid, b.optimum.grid)
                   for a, b in zip(out, again)):
            raise Failed(f"fleet {label}: a second advise differs")
        # padding: the first n - 6 clusters pad up to the same bucket
        cut = profiles[:len(profiles) - 6]
        padded = advisor_of(buckets=(len(profiles),)).advise(cut)
        if not all(rows_equal(a.optimum.grid, b.optimum.grid)
                   for a, b in zip(padded, out)):
            raise Failed(f"fleet {label}: padded lanes moved real rows")
        # submit order: a shuffled stream comes back in its own order
        order = np.random.default_rng(1).permutation(len(profiles))
        shuffled = advisor_of().advise([profiles[i] for i in order])
        if [a.request_id for a in shuffled] != list(range(len(profiles))) \
                or not all(a.profile is profiles[i] and rows_equal(
                    a.optimum.grid, out[i].optimum.grid)
                    for a, i in zip(shuffled, order)):
            raise Failed(f"fleet {label}: answers out of submit order")
        sharded = advisor_of(shard=True).advise(profiles)
        if not all(rows_equal(a.optimum.grid, b.optimum.grid)
                   and a.best == b.best for a, b in zip(sharded, out)):
            raise Failed(f"fleet {label}: shard=True differs")
        timing = entry_point_timing(
            lambda: advisor.advise(profiles), reps=3,
            parts=(("stack", optimize, "fleet_policy_inputs"),
                   ("fleet_core", sweep, "_renewal_fleet_mc_core"),
                   ("reduce", optimize, "_policy_eval_from_stats"),
                   ("front", optimize, "_optimum_from_grid")))
        t0 = time.perf_counter()
        for p in profiles:
            optimize.optimize_policy(
                p.scenario(), key, table=table, process=p.failure_process(),
                work_s=p.work_s, device="cuda", **kw)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
        batched_ms = float(timing["wall_ms_median"])
        line("fleet", fleet=label, card=repr(card_line),
             clusters=len(profiles), buckets=n_buckets, policies=len(table),
             runs=FLEET_RUNS, failures=FLEET_FAILURES,
             checked_clusters="/".join(map(str, picks)),
             standalone="bit-equal", padding="inert", submit_order="kept",
             shard="bit-equal", cache_second_advise=(
                 f"hits+{second.hits - first.hits},traces+0"),
             advisories_per_s=f"{len(profiles) / (batched_ms * 1e-3):.2f}",
             loop_wall_ms=f"{loop_ms:.3f}",
             loop_advisories_per_s=f"{len(profiles) / (loop_ms * 1e-3):.2f}",
             speedup=f"{loop_ms / batched_ms:.3f}", **timing)


def campaign_phase(card_line: str, sweep, prng) -> None:
    """``[campaign]``: the ``fleet`` and ``policy_grid`` presets into a
    store on the card, each cell's record equal to a direct
    ``renewal_monte_carlo_policies`` dispatch of that cell; ``smoke`` cut
    by ``--limit-seed`` and resumed by ``--expect-skipped-seed`` through
    the CLI, store-diff-identical to an uninterrupted run, a rerun
    computing zero cells; a small ``chunk_budget_mb`` giving the same
    records."""
    import shutil

    from repro_torch.campaign import __main__ as cli
    from repro_torch.campaign import presets, runner, spec, store

    root = ROOT / "build" / "campaign_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        for name in ("fleet", "policy_grid"):
            camp = presets.PRESETS[name]()
            rep = runner.run_campaign(camp, store.ResultStore(root / name),
                                      device="cuda")
            if rep.n_computed != len(camp):
                raise Failed(f"campaign {name}: {rep.n_computed} of "
                             f"{len(camp)} cells computed")
            for cell, rec in zip(camp.cells, rep.records):
                exp = spec.resolve(cell.config)
                _, st = sweep._renewal_device_inputs([exp.cfg], torch.float64,
                                                     "cuda")
                stats = sweep._stats_to_host(sweep.renewal_monte_carlo_policies(
                    st, prng.PRNGKey(exp.seed), makespan_s=np.asarray(
                        [exp.makespan_s]), n_runs=exp.n_runs,
                    max_failures=exp.max_failures, process=exp.process,
                    topology=exp.topology, stats=True))
                want = runner.summary_to_result(
                    sweep._summarize_device_scenario(
                        stats, 0, n_runs=exp.n_runs,
                        makespan_s=exp.makespan_s, mtbf_s=float(np.mean(
                            exp.process.mean_s())),
                        max_failures=exp.max_failures))
                want["mean_makespan_s"] = float(stats["end_time"][0].mean())
                if store.canonical_json(rec["result"]) != \
                        store.canonical_json(want):
                    raise Failed(f"campaign {name}: {cell.cell_id()} differs "
                                 "from a direct dispatch")
            extra = {}
            if name == "fleet":
                runner.run_campaign(camp, store.ResultStore(root / "chunked"),
                                    chunk_budget_mb=1e-6, device="cuda")
                diffs = store.diff_stores(root / name, root / "chunked")
                if diffs:
                    raise Failed(f"campaign chunking: {diffs[:3]}")
                extra = {"one_lane_chunks": "store-diff-identical"}
            line("campaign", preset=name, card=repr(card_line),
                 cells=len(camp), runs=camp.cells[0].config["run"]["n_runs"],
                 failures=camp.cells[0].config["run"]["max_failures"],
                 dispatches=rep.n_chunks, direct_dispatch="equal", **extra,
                 **entry_point_timing(lambda c=camp: runner.run_campaign(
                     c, None, device="cuda"), reps=2))
        cut, full = str(root / "cut"), str(root / "full")
        run = ["run", "--preset", "smoke", "--device", "cuda"]
        for argv in (run + ["--store", cut, "--limit-seed", str(CAMPAIGN_CUT_SEED)],
                     run + ["--store", cut, "--expect-skipped-seed",
                            str(CAMPAIGN_CUT_SEED)],
                     run + ["--store", full],
                     ["diff", cut, full],
                     run + ["--store", full, "--expect-skipped", "4"]):
            if cli.main(argv) != 0:
                raise Failed(f"campaign CLI: {' '.join(argv)} failed")
        line("campaign", preset="smoke", cli="cut, resume, diff, rerun",
             cut_after=cli._seeded_cut(CAMPAIGN_CUT_SEED, 4),
             resumed="store-diff-identical", rerun_computed=0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# training on the card: the dense family, the train step and AdamW, the FT
# runtime (pod checkpoints, localized rollback, the adaptive controller)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "deepseek-7b"
TRAIN_LAYERS = 2                   # of 30: the only cut (PERF.md §4)
TRAIN_BATCH, TRAIN_LEN = 8, 4096   # train_4k's sequence; its batch 256 cut to 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
FT_STEPS, FT_SCHEDULE = 6, {4: 1}  # pod 1 fails before step 4
DENSE_DECODE_LEN, DENSE_DECODE_TOKENS = 512, 8
# tests/test_controller.py's static run and its bars
CTRL_PODS, CTRL_STEP_S, CTRL_MTBF_S, CTRL_K = 4, 100.0, 2000.0, 0.7
CTRL_INTERVAL_STEPS, CTRL_STEPS, CTRL_KEY = 6, 60, 3
TOL_COMPOSE, TOL_MC = 1e-5, 0.12


def trees_equal(a, b) -> bool:
    """Every leaf of ``a`` and ``b`` bit-equal (same shape and dtype)."""
    from repro_torch._tree import items

    ia, ib = list(items(a)), list(items(b))
    if [p for p, _ in ia] != [p for p, _ in ib]:
        return False
    for (_, x), (_, y) in zip(ia, ib):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if not torch.equal(x, y.to(x.device)):
            return False
    return True


def grad_guard_phase(dev) -> None:
    """A kernel launch under grad mode with an operand that requires grad
    raises; under no_grad the same launch runs."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device=dev)
               for _ in range(3))
    x = torch.randn((1, 64, 2, 64), generator=gen, device=dev)
    dt = torch.rand((1, 64, 2), generator=gen, device=dev)
    a = -torch.rand((2,), generator=gen, device=dev)
    bm, cm = (torch.randn((1, 64, 1, 64), generator=gen, device=dev)
              for _ in range(2))
    calls = {"flash_attention": lambda q_: ops.flash_attention(q_, k, v),
             "ssd_scan": lambda x_: ops.ssd_scan(x_, dt, a, bm, cm, chunk=64)}
    for name, operand in (("flash_attention", q), ("ssd_scan", x)):
        try:
            calls[name](operand.clone().requires_grad_(True))
        except RuntimeError as exc:
            if "no backward" not in str(exc):
                raise
        else:
            raise Failed(f"{name}: a launch under grad returned an output")
        with torch.no_grad():
            calls[name](operand.clone().requires_grad_(True))
    torch.cuda.synchronize()
    line("train-grad-guard", flash_attention="raises under grad",
         ssd_scan="raises under grad", under_no_grad="launched")


def force_reference_phase(dev, fa, ssd) -> None:
    """``force_reference=True`` runs the plain oracles (``kernels.ref``) on
    CUDA tensors and launches nothing; the default launches each kernel
    once, held to the oracle at the flash kernel's plain tolerance and the
    SSD bar (atol 2e-3 / rtol 1e-3)."""
    from repro_torch import spans
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=gen, device=dev)
               for _ in range(3))
    x = torch.randn((2, 256, 4, 64), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((2, 256, 4), generator=gen, device=dev))
    a = -torch.rand((4,), generator=gen, device=dev) - 0.5
    bm, cm = (0.3 * torch.randn((2, 256, 1, 64), generator=gen, device=dev)
              for _ in range(2))
    with torch.no_grad():
        spans.reset_counts()
        ref_o = ops.flash_attention(q, k, v, force_reference=True)
        ref_y, ref_s = ops.ssd_scan(x, dt, a, bm, cm, chunk=128,
                                    force_reference=True)
        torch.cuda.synchronize()
        forced = (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"])
        o = ops.flash_attention(q, k, v)
        y, st = ops.ssd_scan(x, dt, a, bm, cm, chunk=128)
        torch.cuda.synchronize()
        default = (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"])
    atol, rtol = fa.PLAIN_TOL[torch.float32]
    err_o = check_close("force-reference flash", o, ref_o, atol, rtol)
    err_y = max(check_close("force-reference ssd y", y, ref_y, 2e-3, 1e-3),
                check_close("force-reference ssd state", st, ref_s, 2e-3, 1e-3))
    line("force-reference", launches_forced=list(forced),
         launches_default=list(default), flash_max_abs_err=f"{err_o:.3e}",
         ssd_max_abs_err=f"{err_y:.3e}")
    if forced != (0, 0) or default != (1, 1):
        raise Failed(f"force-reference: launches {forced} forced, "
                     f"{default} by default")


def train_phase(card_line: str, fa, ssd) -> tuple:
    """deepseek-7b at its published widths, 2 layers, bf16, 8 x 4096 per
    step in 4 microbatches, AdamW: 2 warm-up steps (step 1 replayed from
    the same state, bit-equal), then 5 timed steps.  Returns the model,
    its config, the optimizer, the step and the pipeline, and the trained
    parameters."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw

    cfg = get_config(TRAIN_ARCH, num_layers=TRAIN_LAYERS)
    model = build_model(cfg, device="cuda")
    opt = adamw(AdamWConfig(learning_rate=3e-4))
    step_fn = make_train_step(model, opt)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                       global_batch=TRAIN_BATCH, device="cuda")
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    state = (params, opt.init(params))
    del params
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    spans.reset_counts()
    losses, times = [], []
    peak, step_growth = 0, 0           # overall peak; a timed step's own
    for step in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = pipe.batch_at(step)
        torch.cuda.synchronize()
        if step >= TRAIN_WARMUP:
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        new = step_fn(*state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step == 1:
            again = step_fn(*state, batch)
            equal = trees_equal(new[:2], again[:2]) and torch.equal(
                new[2]["total_loss"], again[2]["total_loss"])
            line("train-replay", step=1, bit_equal=equal)
            if not equal:
                raise Failed("train: step 1 and its replay differ")
            del again
        if step >= TRAIN_WARMUP:
            step_growth = max(step_growth,
                              torch.cuda.max_memory_allocated() - base)
        state = new[:2]
        losses.append(float(new[2]["total_loss"]))
        del new
    peak_gb = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    if not all(np.isfinite(losses)):
        raise Failed(f"train: non-finite losses {losses}")
    launches = fa.LAUNCHES["flash_attention"] + ssd.LAUNCHES["ssd_scan"]
    if launches:
        raise Failed(f"train: {launches} kernel launches on the plain path")
    step_s = statistics.median(times[TRAIN_WARMUP:])
    tokens = TRAIN_BATCH * TRAIN_LEN
    # where one step's device time goes (its result is dropped)
    print_profile("train-profile", card_line, device_profile(
        lambda: step_fn(*state, pipe.batch_at(TRAIN_WARMUP + TRAIN_TIMED))))
    line("train", arch=TRAIN_ARCH, card=repr(card_line), layers=TRAIN_LAYERS,
         params=n_params, dtype=cfg.dtype, batch=TRAIN_BATCH, seq=TRAIN_LEN,
         microbatches=cfg.train_microbatches, remat=cfg.remat,
         step_ms_median=f"{step_s * 1e3:.3f}",
         steps_ms=[f"{t * 1e3:.3f}" for t in times],
         tokens_per_s=f"{tokens / step_s:.1f}",
         model_flop_share=f"{6.0 * n_params * tokens / step_s / PEAK_BF16_FLOP_PER_S:.4f}",
         peak_gb=f"{peak_gb:.3f}", kernel_launches=launches,
         losses=[f"{x:.6f}" for x in losses])
    step_cost_phase(card_line, step_fn, state,
                    pipe.batch_at(TRAIN_WARMUP + TRAIN_TIMED + 1),
                    6.0 * n_params * tokens, step_s, step_growth)
    return cfg, model, opt, step_fn, pipe, state[0]


def step_cost_phase(card_line: str, step_fn, state, batch, six_nd: float,
                    step_s: float, step_growth: int) -> None:
    """One more [train] step under ``op_analysis.analyze``: its flops
    against 6 N tokens, its fused bytes, and the flop and byte terms at the
    card's peaks beside the measured step.  The step runs no kernel, so
    every operation reaches the dispatcher.  Fails outside 0.8-3.0 x 6ND,
    or if the walk's peak memory grows past a timed step's own."""
    from repro_torch.launch.op_analysis import analyze

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, cost = analyze(step_fn, *state, batch)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    growth = torch.cuda.max_memory_allocated() - base
    del out
    flop_ms = cost.flops / PEAK_BF16_FLOP_PER_S * 1e3
    byte_ms = cost.bytes / PEAK_BYTES_PER_S * 1e3
    line("step-cost", arch=TRAIN_ARCH, card=repr(card_line),
         flops=f"{cost.flops:.6e}", flops_over_6nd=f"{cost.flops / six_nd:.4f}",
         bytes=f"{cost.bytes:.6e}", flop_term_ms=f"{flop_ms:.3f}",
         byte_term_ms=f"{byte_ms:.3f}",
         bound_by="bytes" if byte_ms > flop_ms else "operations",
         step_ms_median=f"{step_s * 1e3:.3f}",
         bound_share=f"{max(flop_ms, byte_ms) / (step_s * 1e3):.4f}",
         walk_s=f"{walk_s:.3f}", walk_peak_growth=growth,
         step_peak_growth=step_growth)
    if not 0.8 * six_nd <= cost.flops <= 3.0 * six_nd:
        raise Failed(f"step-cost: flops {cost.flops:.6e} outside 0.8-3.0 x "
                     f"6ND ({six_nd:.6e})")
    if growth > step_growth:
        raise Failed(f"step-cost: the walk's peak grew by {growth} B, a "
                     f"step's by {step_growth} B")


def ft_train_phase(card_line: str, model, opt, step_fn, pipe) -> None:
    """The [train] model through FTTrainer: 2 pods, checkpoints every 3
    steps, pod 1 fails before step 4 and rolls back to its own checkpoint.
    Held against a plain failure-free loop of the same steps, and the
    failure's decisions against the CPU port's EnergyManager."""
    import shutil

    from repro_torch._tree import tree_map
    from repro_torch.checkpoint.manager import CheckpointConfig
    from repro_torch.ft import runtime

    root = ROOT / "build" / "ft_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        line("ft-train", free_disk_gb=f"{shutil.disk_usage(root).free / 1e9:.1f}",
             root=str(root.relative_to(ROOT)))
        params = model.init(0)
        state = (params, opt.init(params))
        del params
        plain_losses = []
        for s in range(FT_STEPS):
            p, o, m = step_fn(*state, pipe.batch_at(s))
            state = (p, o)
            plain_losses.append(float(m["total_loss"]))
        plain_final = tree_map(lambda t: t.cpu(), state)
        del state, p, o
        gc.collect()

        params = model.init(0)
        trainer = runtime.FTTrainer(
            step_fn=step_fn, pipeline=pipe, state=(params, opt.init(params)),
            cluster=runtime.ClusterSpec(n_pods=2),
            ckpt_cfg=CheckpointConfig(root=str(root), interval_steps=3, keep=1,
                                      phase_offset_steps=1, async_save=True),
            injector=runtime.FailureInjector(dict(FT_SCHEDULE)), device="cuda")
        del params
        seen = []
        on_failure = trainer.energy.on_failure

        def spy(**kw):
            seen.append({k: np.array(v) if isinstance(v, np.ndarray) else v
                         for k, v in kw.items()})
            return on_failure(**kw)

        trainer.energy.on_failure = spy
        t0 = time.perf_counter()
        trainer.run(FT_STEPS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        ev = trainer.events
        if len(ev) != 1 or (ev[0]["pod"], ev[0]["rollback_to"],
                            ev[0]["reexec_steps"]) != (1, 2, 1):
            raise Failed(f"ft-train events {ev}")
        final_equal = trees_equal(trainer.state, plain_final)
        ft_losses = [h["loss"] for h in trainer.history]
        if not final_equal:
            raise Failed("ft-train: the final state differs from the "
                         "failure-free loop")
        if ft_losses != plain_losses:
            raise Failed(f"ft-train losses {ft_losses} != {plain_losses}")
        cpu_ev = runtime.EnergyManager(trainer.energy.cluster, "cpu").on_failure(
            **seen[0])
        card_ev = trainer.energy.events[0]
        same_decisions = cpu_ev.decisions == card_ev.decisions and \
            cpu_ev.saving_j == card_ev.saving_j
        if not same_decisions:
            raise Failed(f"ft-train: card decisions {card_ev.decisions} "
                         f"{card_ev.saving_j} != CPU {cpu_ev.decisions} "
                         f"{cpu_ev.saving_j}")
        line("ft-train", card=repr(card_line), pods=2, steps=FT_STEPS,
             failure=json.dumps(FT_SCHEDULE), rollback_to=ev[0]["rollback_to"],
             reexec_steps=ev[0]["reexec_steps"], wall_s=f"{wall_s:.2f}",
             final_state_vs_failure_free="bit-equal",
             losses_vs_failure_free="equal",
             decisions_vs_cpu_energy_manager="equal",
             saving_j=f"{card_ev.saving_j:.6f}",
             saving_pct=f"{card_ev.saving_pct:.4f}",
             actions=json.dumps({p: d["wait_action"]
                                 for p, d in card_ev.decisions.items()}),
             losses=[f"{x:.6f}" for x in ft_losses])
        total = 0
        for pod, mgr in enumerate(trainer.managers):
            for rec in mgr.io_log:
                total += rec["bytes"] if rec["op"] == "save" else 0
                line("ft-io", card=repr(card_line), op=rec["op"], pod=pod,
                     step=rec["step"], bytes=rec["bytes"],
                     seconds=f"{rec['seconds']:.3f}",
                     gb_per_s=f"{rec['bytes'] / rec['seconds'] / 1e9:.3f}",
                     **({"host_copy_seconds": f"{rec['copy_seconds']:.3f}"}
                        if "copy_seconds" in rec else {}))
        line("ft-io", saves=sum(m.saves for m in trainer.managers),
             bytes_written=total)
        del trainer, plain_final
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()


def ft_adaptive_phase(card_line: str) -> None:
    """``python -m repro_torch.launch.train --arch deepseek-7b --adaptive
    --device cuda`` in this process (smoke config, 4 pods, the reference's
    defaults), then a static run reconciled against the renewal engine at
    tests/test_controller.py's settings and bars."""
    import io
    import shutil

    from repro_torch.checkpoint.manager import CheckpointConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import failures, prng
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft import (ClusterSpec, FTTrainer,
                                StochasticFailureInjector, reconcile_ledger)
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw

    root = ROOT / "build" / "ft_adaptive"
    shutil.rmtree(root, ignore_errors=True)
    try:
        argv = ["--arch", TRAIN_ARCH, "--adaptive", "--device", "cuda",
                "--ckpt-dir", str(root / "cli")]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer = train.main(argv)
        wall_s = time.perf_counter() - t0
        ctl = trainer.controller
        for text in out.getvalue().splitlines():
            line("ft-adaptive-cli", out=repr(text))
        if not ctl.retunes or not trainer.events:
            raise Failed("ft-adaptive: no failure or no retune")
        line("ft-adaptive", card=repr(card_line), argv=repr(" ".join(argv[:-2])),
             steps=len(trainer.history), failures=len(trainer.events),
             retunes=len(ctl.retunes), wall_s=f"{wall_s:.2f}",
             retune_wall_s=[f"{r.wall_s:.3f}" for r in ctl.retunes],
             ledger_mj=f"{trainer.energy.ledger_total_j() / 1e6:.6f}",
             final_interval_steps=trainer.managers[0].cfg.interval_steps)
        del trainer, ctl

        cfg = get_smoke_config(TRAIN_ARCH)
        model = build_model(cfg, device="cuda")
        opt = adamw(AdamWConfig(learning_rate=3e-4))
        params = model.init(0)
        process = failures.Weibull.from_mtbf(CTRL_K, CTRL_MTBF_S)
        injector = StochasticFailureInjector(
            process, prng.PRNGKey(CTRL_KEY), n_pods=CTRL_PODS, max_failures=32,
            n_runs=4, run_index=1, device="cuda")
        static = FTTrainer(
            step_fn=make_train_step(model, opt),
            pipeline=SyntheticLM(cfg.vocab_size, 64, 8, device="cuda"),
            state=(params, opt.init(params)),
            cluster=ClusterSpec(n_pods=CTRL_PODS, step_time_s=CTRL_STEP_S),
            ckpt_cfg=CheckpointConfig(root=str(root / "static"),
                                      interval_steps=CTRL_INTERVAL_STEPS,
                                      keep=3, phase_offset_steps=1),
            injector=injector, ckpt_duration_s=120.0, device="cuda")
        t0 = time.perf_counter()
        static.run(CTRL_STEPS)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = reconcile_ledger(static, device="cuda")
        rec_s = time.perf_counter() - t0
        line("ft-adaptive", static_run="tests/test_controller.py settings",
             pods=CTRL_PODS, steps=CTRL_STEPS, failures=rep.n_failures,
             run_s=f"{run_s:.2f}", reconcile_s=f"{rec_s:.2f}",
             ledger_j=f"{rep.ledger_j:.6f}", compose_j=f"{rep.compose_j:.6f}",
             rel_err_compose=f"{rep.rel_err_compose:.3e}",
             mc_j=f"{rep.mc_j:.6f}", rel_err_mc=f"{rep.rel_err_mc:.4f}")
        if rep.n_failures < 3 or not rep.rel_err_compose < TOL_COMPOSE or \
                not rep.rel_err_mc < TOL_MC:
            raise Failed(f"ft-adaptive: reconcile {rep}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dense_prefill_phase(card_line: str, cfg, params, fa) -> float:
    """The [train] model's weights through the flash kernel: a bf16 prefill
    of 2 x 4096 (one launch per layer; the first held against the plain
    version, timed alone against it and SDPA), the float32 cast of the
    weights against the plain path at 2 x 4096, and 8 decoded tokens
    against the prefill.  Returns the worst kernel-vs-plain error."""
    from repro_torch import spans
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    kern = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    plain = build_model(cfg, "cuda")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)), device=dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(kern)
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != cfg.num_layers or not torch.isfinite(last).all():
        raise Failed(f"dense prefill: {launches} flash launches, finite "
                     f"{bool(torch.isfinite(last).all())}")
    fa_args, fa_kw, fa_out = cap[0]
    last_plain = make_prefill_step(plain)(params, batch)
    bf16_diff = float((last - last_plain).abs().max())
    _, wall_ms = wall_ms_median(lambda: prefill(params, batch), 3)
    err = flash_launch_timing("deepseek", card_line, fa, fa_args, fa_kw,
                              fa_out)["max_abs_err"]
    sdpa_timing("deepseek", card_line, fa_args, fa_kw, cfg.num_heads, fa_out)
    line("dense-prefill", arch=TRAIN_ARCH, card=repr(card_line),
         layers=cfg.num_layers, dtype="bfloat16", batch=PREFILL_BATCH,
         tokens=PREFILL_LEN, flash_launches=launches,
         wall_ms_median=f"{wall_ms:.3f}",
         tokens_per_s=f"{PREFILL_BATCH * PREFILL_LEN / (wall_ms * 1e-3):.1f}",
         first_launch_max_abs_err=f"{err:.3e}",
         bf16_last_logits_vs_plain_path_max_abs=f"{bf16_diff:.4e}")
    del cap, fa_args, fa_out, last, last_plain
    free_cuda()

    # float32: the kernel path against the plain path over every position,
    # then DENSE_DECODE_TOKENS decoded tokens against the prefill
    p32 = _to_float32(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kern32 = build_model(dataclasses.replace(cfg32, use_flash_kernel=True), "cuda")
    plain32 = build_model(cfg32, "cuda")
    with torch.inference_mode():
        got, _ = kern32.forward(p32, batch)
        want, _ = plain32.forward(p32, batch)
    err32 = check_close("dense float32 prefill kernel path vs plain path",
                        got, want, *TOL_SSD)
    del got, want
    short = tokens[:, :DENSE_DECODE_LEN]
    with torch.inference_mode():
        pre, _ = kern32.forward(p32, {"tokens": short})
        cache = kern32.init_cache(PREFILL_BATCH, DENSE_DECODE_LEN)
        worst_dec, argmax_equal = 0.0, True
        for t in range(DENSE_DECODE_LEN):
            logits, cache = kern32.decode_step(p32, cache, short[:, t:t + 1], t)
            if t >= DENSE_DECODE_LEN - DENSE_DECODE_TOKENS:
                worst_dec = max(worst_dec, check_close(
                    f"dense decode token {t} vs prefill", logits[:, 0],
                    pre[:, t], *TOL_DECODE))
                argmax_equal &= bool(torch.equal(logits[:, 0].argmax(-1),
                                                 pre[:, t].argmax(-1)))
    if not argmax_equal:
        raise Failed("dense decode and prefill disagree on an argmax")
    line("dense-prefill", dtype="float32", kernel_vs_plain_max_abs=f"{err32:.3e}",
         kernel_vs_plain_tol=TOL_SSD, decoded_tokens=DENSE_DECODE_TOKENS,
         of_prompt=DENSE_DECODE_LEN, decode_vs_prefill_max_abs=f"{worst_dec:.3e}",
         decode_tol=TOL_DECODE, argmax_equal=argmax_equal)
    del p32, cache, pre, kern32, plain32
    free_cuda()
    return err


def _to_float32(tree):
    return {k: _to_float32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def training_path(card_line: str, fa, ssd) -> float:
    """Phases 14-18: training on the card.  Returns the worst flash error
    against its plain version on the dense prefill."""
    dev = torch.device("cuda")
    free_cuda()
    grad_guard_phase(dev)
    force_reference_phase(dev, fa, ssd)
    cfg, model, opt, step_fn, pipe, trained = train_phase(card_line, fa, ssd)
    free_cuda()
    ft_train_phase(card_line, model, opt, step_fn, pipe)
    ft_adaptive_phase(card_line)
    err = dense_prefill_phase(card_line, cfg, trained, fa)
    del trained, model
    free_cuda()
    return err


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the moe and encoder-decoder families, gradient compression
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_BATCH, MOE_LEN = 2, 4096
MOE_CHECK_LEN = 1024               # the float32 kernel-path check
MOE_DECODE_LEN = 128
MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_LAYERS = 2                 # of 56: the only cut (PERF.md §4)
MIXTRAL_BATCH, MIXTRAL_LEN = 2, 8192
WHISPER_ARCH = "whisper-medium"
# Whisper's 30 s of audio (1500 frames) and text context (448 tokens),
# arXiv:2212.04356
WHISPER_BATCH, WHISPER_TOKENS = 8, 448
WHISPER_DECODE_BATCH, WHISPER_DECODE_LEN = 2, 64
MOE_TRAIN_LAYERS = 1               # of 16: room for [dryrun] in the time limit
MOE_TRAIN_BATCH, MOE_TRAIN_LEN = 4, 2048
MOE_TRAIN_WARMUP, MOE_TRAIN_TIMED = 2, 3
TOPK_RATIO = 0.05


def expert_ids(i, args, kw, out):
    return out[1].clone()


def route_flips(a: list, b: list) -> int:
    """(token, layer) pairs whose set of experts differs between two runs."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def drop_share(moe, ids: list, cfg, batch: int, seq: int) -> tuple:
    """Share of the (token, slot) pairs of a forward that went past their
    expert's capacity, from each layer's expert ids (N, K): over all layers
    and per layer."""
    e, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    per_layer = []
    for eidx in ids:
        if cfg.moe.dispatch == "row":
            cap = int(np.ceil(seq * k * cf / e))
            slot = moe._slots(eidx.reshape(batch, seq * k), e, cap)
        else:
            cap = int(np.ceil(batch * seq * k * cf / e))
            slot = moe._slots(eidx.reshape(-1), e, cap)
        per_layer.append(float((slot == e * cap).float().mean()))
    return sum(per_layer) / len(per_layer), per_layer


def moe_phase(card_line: str, fa) -> list:
    """olmoe-1b-7b at its published config, full width and depth: a bf16
    prefill of 2 x 4096 (16 flash launches; the drop share at capacity
    factor 1.25; the first launch held against the plain version and
    timed), the bf16 serve loop, then float32 with the capacity raised to
    E/K (nothing drops): the kernel path against the plain path at 2 x
    1024 with the differing routes counted, and 2 x 128 decoded tokens
    against the forward.  Returns the flash launch records."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, moe

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH, use_flash_kernel=True)
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_LEN)), device=dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap, \
            recorded(moe, "_route", expert_ids) as ids:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != cfg.num_layers or len(ids) != cfg.num_layers or \
            not torch.isfinite(last).all():
        raise Failed(f"moe prefill: {launches} flash launches, {len(ids)} "
                     f"routed layers, finite {bool(torch.isfinite(last).all())}")
    drops, layer_drops = drop_share(moe, ids, cfg, MOE_BATCH, MOE_LEN)
    del ids, last
    _, wall_ms = wall_ms_median(lambda: prefill(params, batch), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print_profile("moe-prefill-profile", card_line,
                  device_profile(lambda: prefill(params, batch)))
    line("moe-prefill", arch=MOE_ARCH, card=repr(card_line), params=n_params,
         init_s=f"{init_s:.2f}", dtype=cfg.dtype, layers=cfg.num_layers,
         dispatch=cfg.moe.dispatch, batch=MOE_BATCH, tokens=MOE_LEN,
         flash_launches=launches, wall_ms_median=f"{wall_ms:.3f}",
         tokens_per_s=f"{MOE_BATCH * MOE_LEN / (wall_ms * 1e-3):.1f}",
         peak_gb=f"{peak_gb:.3f}",
         capacity_factor=cfg.moe.capacity_factor,
         dropped_pair_share=f"{drops:.6f}",
         per_layer=[f"{x:.4f}" for x in layer_drops])
    fa_args, fa_kw, fa_out = cap[0]
    records = [flash_launch_timing("olmoe", card_line, fa, fa_args, fa_kw,
                                   fa_out)]
    records[0]["sdpa_ms"] = sdpa_timing("olmoe", card_line, fa_args, fa_kw,
                                        cfg.num_heads, fa_out)
    records[0]["launches"] = launches
    del cap, fa_args, fa_out

    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    spans.reset_counts()
    res = serve.serve(model, params, prompts, SERVE_GEN)
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or toks.min() < 0 or \
            toks.max() >= cfg.padded_vocab_size:
        raise Failed(f"moe serve loop tokens: shape {toks.shape}")
    line("moe-decode", arch=MOE_ARCH, loop="serve", dtype=cfg.dtype,
         card=repr(card_line), batch=SERVE_BATCH, bucket=res["bucket"],
         prompt=SERVE_PROMPT, gen=SERVE_GEN,
         tokens_per_s=f"{res['tokens_per_s']:.2f}",
         flash_launches=fa.LAUNCHES["flash_attention"],
         first_row=toks[0, :8].tolist())
    del model, params, prefill, batch
    free_cuda()

    # float32 with capacity E/K: the kernel path against the plain path,
    # decode against the forward
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))
    kern = build_model(cfg32, "cuda")
    plain = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                        "cuda")
    p32 = kern.init(0)
    short = tokens[:, :MOE_CHECK_LEN]
    spans.reset_counts()
    with torch.inference_mode():
        with recorded(moe, "_route", expert_ids) as ids_k:
            got, aux_k = kern.forward(p32, {"tokens": short})
        launches32 = fa.LAUNCHES["flash_attention"]
        with recorded(moe, "_route", expert_ids) as ids_p:
            want, aux_p = plain.forward(p32, {"tokens": short})
    flips = route_flips(ids_k, ids_p)
    line("moe-prefill", dtype="float32", tokens=MOE_CHECK_LEN,
         capacity_factor=cfg32.moe.capacity_factor, flash_launches=launches32,
         routes=len(ids_k) * MOE_BATCH * MOE_CHECK_LEN,
         routes_differing_kernel_vs_plain=flips,
         aux_kernel=f"{float(aux_k):.7f}", aux_plain=f"{float(aux_p):.7f}")
    if launches32 != cfg.num_layers:
        raise Failed(f"moe float32 prefill: {launches32} flash launches")
    err32 = check_close("moe float32 prefill kernel path vs plain path", got,
                        want, *TOL_SSD)
    line("moe-prefill", dtype="float32", kernel_vs_plain_max_abs=f"{err32:.3e}",
         kernel_vs_plain_tol=TOL_SSD)
    del got, want, ids_k, ids_p
    dec_toks = tokens[:, :MOE_DECODE_LEN]
    with torch.inference_mode():
        pre, _ = kern.forward(p32, {"tokens": dec_toks})
        cache = kern.init_cache(MOE_BATCH, MOE_DECODE_LEN)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MOE_DECODE_LEN):
            logits, cache = kern.decode_step(p32, cache, dec_toks[:, t:t + 1], t)
            outs.append(logits[:, 0])
        dec = torch.stack(outs, dim=1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    argmax_equal = int((dec.argmax(-1) == pre.argmax(-1)).sum())
    err_dec = check_close("moe float32 decode vs forward", dec, pre, *TOL_DECODE)
    line("moe-decode", arch=MOE_ARCH, dtype="float32", layers=cfg.num_layers,
         capacity_factor=cfg32.moe.capacity_factor,
         capacity_note="E/K: nothing drops, so the capacity path computes "
                       "what decode's dense path does",
         batch=MOE_BATCH, tokens=MOE_DECODE_LEN,
         decode_vs_forward_max_abs=f"{err_dec:.3e}", tol=TOL_DECODE,
         argmax_equal=f"{argmax_equal}/{dec.shape[0] * dec.shape[1]}",
         decode_s=f"{dec_s:.2f}",
         tokens_per_s=f"{MOE_BATCH * MOE_DECODE_LEN / dec_s:.2f}")
    del kern, plain, p32, pre, cache, dec, outs, tokens
    free_cuda()
    return records


def mixtral_phase(card_line: str, fa) -> list:
    """mixtral-8x22b at full width, 2 of its 56 layers, bf16, 2 x 8192
    tokens, row dispatch: 2 flash launches at group 6 and window 4096, the
    first held against its plain version (per KV head) and timed alone,
    against SDPA with the window as a boolean mask."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, moe

    dev = torch.device("cuda")
    cfg = get_config(MIXTRAL_ARCH, num_layers=MIXTRAL_LAYERS,
                     use_flash_kernel=True)
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (MIXTRAL_BATCH, MIXTRAL_LEN)), device=dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap, \
            recorded(moe, "_route", expert_ids) as ids:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != MIXTRAL_LAYERS or not torch.isfinite(last).all():
        raise Failed(f"mixtral prefill: {launches} flash launches, finite "
                     f"{bool(torch.isfinite(last).all())}")
    drops, layer_drops = drop_share(moe, ids, cfg, MIXTRAL_BATCH, MIXTRAL_LEN)
    del ids, last
    _, wall_ms = wall_ms_median(lambda: prefill(params, batch), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print_profile("mixtral-prefill-profile", card_line,
                  device_profile(lambda: prefill(params, batch)))
    line("mixtral-prefill", arch=MIXTRAL_ARCH, card=repr(card_line),
         layers=MIXTRAL_LAYERS, params=n_params, dtype=cfg.dtype,
         dispatch=cfg.moe.dispatch, window=cfg.sliding_window,
         group=cfg.num_heads // cfg.num_kv_heads, batch=MIXTRAL_BATCH,
         tokens=MIXTRAL_LEN, flash_launches=launches,
         wall_ms_median=f"{wall_ms:.3f}",
         tokens_per_s=f"{MIXTRAL_BATCH * MIXTRAL_LEN / (wall_ms * 1e-3):.1f}",
         peak_gb=f"{peak_gb:.3f}", capacity_factor=cfg.moe.capacity_factor,
         dropped_pair_share=f"{drops:.6f}",
         per_layer=[f"{x:.4f}" for x in layer_drops])
    fa_args, fa_kw, fa_out = cap[0]
    del cap, model, params, prefill, batch, tokens
    free_cuda()
    rec = flash_launch_timing("mixtral", card_line, fa, fa_args, fa_kw, fa_out,
                              plain_chunks=True)
    rec["sdpa_ms"] = sdpa_timing("mixtral", card_line, fa_args, fa_kw,
                                 cfg.num_heads, fa_out)
    rec["launches"] = launches
    del fa_args, fa_out
    free_cuda()
    return [rec]


def encdec_phase(card_line: str, fa) -> list:
    """whisper-medium at its published config (24 + 24 layers), bf16, 8 x
    1500 frames and 8 x 448 decoder tokens: 24 flash launches (decoder
    self-attention; the encoder and cross-attention launch none), the
    first held against its plain version and timed; the decode loop with
    the encoder's output, and one decode step with 1500 encoder frames
    against one with a single frame (the per-step recomputation of
    cross-attention); then float32: the kernel path against the plain
    path, and 2 x 64 decoded tokens against the forward."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, encdec

    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH, use_flash_kernel=True)
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(8)
    frames = torch.randn((WHISPER_BATCH, cfg.encdec.enc_len, cfg.d_model),
                         generator=gen, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_TOKENS)), device=dev)
    batch = {"frames": frames, "tokens": tokens}
    prefill = make_prefill_step(model)
    spans.reset_counts()
    with recorded(ops, "flash_attention_bhsd", first_call) as cap:
        last = prefill(params, batch)
        torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != cfg.num_layers or not torch.isfinite(last).all():
        raise Failed(f"encdec forward: {launches} flash launches, finite "
                     f"{bool(torch.isfinite(last).all())}")
    del last
    _, wall_ms = wall_ms_median(lambda: prefill(params, batch), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print_profile("encdec-profile", card_line,
                  device_profile(lambda: prefill(params, batch)))
    line("encdec", arch=WHISPER_ARCH, card=repr(card_line), params=n_params,
         dtype=cfg.dtype, enc_layers=cfg.encdec.enc_layers,
         dec_layers=cfg.num_layers, batch=WHISPER_BATCH,
         frames=cfg.encdec.enc_len, tokens=WHISPER_TOKENS,
         flash_launches=launches, wall_ms_median=f"{wall_ms:.3f}",
         frames_per_s=f"{WHISPER_BATCH * cfg.encdec.enc_len / (wall_ms * 1e-3):.1f}",
         decoder_tokens_per_s=f"{WHISPER_BATCH * WHISPER_TOKENS / (wall_ms * 1e-3):.1f}",
         peak_gb=f"{peak_gb:.3f}")
    fa_args, fa_kw, fa_out = cap[0]
    rec = flash_launch_timing("whisper", card_line, fa, fa_args, fa_kw, fa_out)
    rec["sdpa_ms"] = sdpa_timing("whisper", card_line, fa_args, fa_kw,
                                 cfg.num_heads, fa_out)
    rec["launches"] = launches
    del cap, fa_args, fa_out

    # the decode loop: a 16-token prompt, then 32 greedy tokens, with the
    # encoder's output in the cache
    step = make_serve_step(model)
    with torch.inference_mode():
        enc_out = encdec.encode(params, frames, cfg)
    cache = model.init_cache(WHISPER_BATCH, SERVE_PROMPT + SERVE_GEN)
    cache["enc_out"] = enc_out
    tok = None
    for t in range(SERVE_PROMPT):
        tok, cache = step(params, cache, tokens[:, t:t + 1], t)
    out = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN - 1):
        tok, cache = step(params, cache, out[-1][:, None], t)
        out.append(tok)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    # device time of one step with the 1500 frames and with a single one:
    # their difference is the per-step recomputation of cross-attention
    at = SERVE_PROMPT + SERVE_GEN - 1
    one = dict(cache, enc_out=enc_out[:, :1].contiguous())
    full = device_profile(lambda: step(params, cache, tok[:, None], at))
    single = device_profile(lambda: step(params, one, tok[:, None], at))
    print_profile("encdec-decode-profile", card_line, full)
    if full["device_ms"] is None or single["device_ms"] is None:
        share = "not measured (the trace holds no device time)"
    else:
        share = f"{(full['device_ms'] - single['device_ms']) / full['wall_ms']:.4f}"
    line("encdec", loop="decode", dtype=cfg.dtype, batch=WHISPER_BATCH,
         prompt=SERVE_PROMPT, gen=SERVE_GEN, card=repr(card_line),
         tokens_per_s=f"{WHISPER_BATCH * (SERVE_GEN - 1) / loop_s:.2f}",
         step_wall_ms=f"{full['wall_ms']:.3f}",
         step_device_ms_1500_frames=full["device_ms"],
         step_device_ms_1_frame=single["device_ms"],
         cross_attention_recompute_share_of_step=share,
         first_row=torch.stack(out, 1)[0, :8].tolist())
    del cache, one, enc_out, out, step
    p32 = _to_float32(params)
    del model, params, prefill
    free_cuda()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kern = build_model(cfg32, "cuda")
    plain = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                        "cuda")
    spans.reset_counts()
    with torch.inference_mode():
        got, _ = kern.forward(p32, batch)
        launches32 = fa.LAUNCHES["flash_attention"]
        want, _ = plain.forward(p32, batch)
    if launches32 != cfg.num_layers:
        raise Failed(f"encdec float32: {launches32} flash launches")
    err32 = check_close("encdec float32 kernel path vs plain path", got, want,
                        *TOL_SSD)
    del got, want
    free_cuda()
    b, s = WHISPER_DECODE_BATCH, WHISPER_DECODE_LEN
    short = {"frames": frames[:b], "tokens": tokens[:b, :s]}
    with torch.inference_mode():
        pre, _ = kern.forward(p32, short)
        cache = kern.init_cache(b, s)
        cache["enc_out"] = encdec.encode(p32, short["frames"], cfg32)
        outs = []
        for t in range(s):
            logits, cache = kern.decode_step(p32, cache,
                                             short["tokens"][:, t:t + 1], t)
            outs.append(logits[:, 0])
        dec = torch.stack(outs, dim=1)
    err_dec = check_close("encdec float32 decode vs forward", dec, pre,
                          *TOL_DECODE)
    line("encdec", dtype="float32", flash_launches=launches32,
         kernel_vs_plain_max_abs=f"{err32:.3e}", kernel_vs_plain_tol=TOL_SSD,
         decode_batch=b, decode_tokens=s, enc_out="the encoder's",
         decode_vs_forward_max_abs=f"{err_dec:.3e}", decode_tol=TOL_DECODE,
         argmax_equal=f"{int((dec.argmax(-1) == pre.argmax(-1)).sum())}/{b * s}")
    del kern, plain, p32, pre, dec, cache, outs, frames, tokens, batch
    free_cuda()
    return [rec]


def moe_train_phase(card_line: str, fa) -> tuple:
    """olmoe-1b-7b's widths cut to 1 layer, bf16, AdamW, 4 x 2048 tokens
    per step in its 4 microbatches: warm-up steps (step 1 replayed from the
    same state, bit-equal), then timed steps.  Returns the last step's
    gradients and the parameters they were taken at."""
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, Optimizer, adamw

    cfg = get_config(MOE_ARCH, num_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg, device="cuda")
    opt = adamw(AdamWConfig(learning_rate=3e-4))
    keep: dict = {}

    def update(grads, state, params):
        if keep.pop("want", False):
            keep["grads"], keep["params"] = grads, params
        return opt.update(grads, state, params)

    step_fn = make_train_step(model, Optimizer(opt.init, update))
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_LEN,
                       global_batch=MOE_TRAIN_BATCH, device="cuda")
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    state = (params, opt.init(params))
    del params
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    spans.reset_counts()
    losses, auxes, times = [], [], []
    n_steps = MOE_TRAIN_WARMUP + MOE_TRAIN_TIMED
    for step in range(n_steps):
        batch = pipe.batch_at(step)
        if step == n_steps - 1:
            keep["want"] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = step_fn(*state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step == 1:
            again = step_fn(*state, batch)
            equal = trees_equal(new[:2], again[:2]) and torch.equal(
                new[2]["total_loss"], again[2]["total_loss"])
            line("moe-train-replay", step=1, bit_equal=equal)
            if not equal:
                raise Failed("moe-train: step 1 and its replay differ")
            del again
        state = new[:2]
        losses.append(float(new[2]["total_loss"]))
        auxes.append(float(new[2]["aux_loss"]))
        del new
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (all(np.isfinite(losses)) and all(np.isfinite(auxes))) or \
            min(auxes) <= 0.0:
        raise Failed(f"moe-train: losses {losses}, aux {auxes}")
    if fa.LAUNCHES["flash_attention"]:
        raise Failed("moe-train: kernel launches on the plain path")
    step_s = statistics.median(times[MOE_TRAIN_WARMUP:])
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_LEN
    active = cfg.active_param_count()
    line("moe-train", arch=MOE_ARCH, card=repr(card_line),
         layers=MOE_TRAIN_LAYERS, params=n_params, dtype=cfg.dtype,
         dispatch=cfg.moe.dispatch, capacity_factor=cfg.moe.capacity_factor,
         batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_LEN,
         microbatches=cfg.train_microbatches, remat=cfg.remat,
         step_ms_median=f"{step_s * 1e3:.3f}",
         steps_ms=[f"{t * 1e3:.3f}" for t in times],
         tokens_per_s=f"{tokens / step_s:.1f}",
         active_params=active,
         model_flop_share=f"{6.0 * active * tokens / step_s / PEAK_BF16_FLOP_PER_S:.4f}",
         peak_gb=f"{peak_gb:.3f}", losses=[f"{x:.6f}" for x in losses],
         aux_losses=[f"{x:.6f}" for x in auxes])
    grads, params = keep["grads"], keep["params"]
    del state, model, step_fn
    free_cuda()
    return grads, params


def compression_phase(card_line: str, grads, params) -> None:
    """``wrap_optimizer`` (int8, top-k 5 %) over AdamW on the card, on the
    gradients of one [moe-train] step: two updates, so the second sees the
    first's residual.  Per leaf, sent + residual is the compressed input
    bit for bit; int8 equals the CPU port's on the same gradients and
    residual; top-k's decompressed tensor equals the CPU's where the kept
    sets are equal (the count of leaves where they are not is printed)."""
    from repro_torch._tree import items, leaves, tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw
    from repro_torch.parallel import compression as comp

    n = sum(t.numel() for t in _leaves(grads))
    for method in ("int8", "topk"):
        ccfg = comp.CompressionConfig(method=method, topk_ratio=TOPK_RATIO)
        opt = comp.wrap_optimizer(adamw(AdamWConfig(learning_rate=3e-4)), ccfg)
        state = opt.init(params)
        _, state = opt.update(grads, state, params)
        residual = state["residual"]
        update_ms = statistics.median(cuda_ms(
            lambda: opt.update(grads, state, params), reps=3, warmup=1))
        compress_ms = statistics.median(cuda_ms(
            lambda: comp._compress_tree(grads, residual, ccfg), reps=3,
            warmup=1))
        sent, res = comp._compress_tree(grads, residual, ccfg)
        _, again = opt.update(grads, state, params)
        if not trees_equal(again["residual"], res):
            raise Failed(f"compression {method}: the update's residual "
                         f"differs from _compress_tree's")
        del again
        for (path, s), r, g, r0 in zip(items(sent), leaves(res),
                                       leaves(grads),
                                       leaves(residual)):
            if not torch.equal(s + r, g.float() + r0):
                raise Failed(f"compression {method} {path}: sent + residual "
                             f"!= g + r")
        # the CPU port on the same gradients and residual
        cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
        t0 = time.perf_counter()
        if method == "int8":
            sent_cpu, res_cpu = comp._compress_tree(cpu(grads), cpu(residual),
                                                    ccfg)
            cpu_s = time.perf_counter() - t0
            same = trees_equal(cpu(sent), sent_cpu) and \
                trees_equal(cpu(res), res_cpu)
            if not same:
                raise Failed("compression int8: card and CPU differ")
            detail = {"card_vs_cpu": "bit-equal"}
        else:
            n_leaves = other_sets = ties = 0
            xs_cpu = [g.cpu().float() + r.cpu()
                      for g, r in zip(leaves(grads), leaves(residual))]
            # the CPU's top-k of one leaf runs on one core: a thread per leaf
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                on_cpu = list(pool.map(
                    lambda x: comp.topk_compress(x, TOPK_RATIO), xs_cpu))
            for ((path, g), r, x_cpu, (kept_c, idx_c, _)) in zip(
                    items(grads), leaves(residual), xs_cpu, on_cpu):
                kept, idx, shape = comp.topk_compress(g.float() + r, TOPK_RATIO)
                n_leaves += 1
                dense = comp.topk_decompress(kept, idx, shape).cpu()
                dense_c = comp.topk_decompress(kept_c, idx_c, shape)
                if torch.equal(idx.sort().values.cpu(), idx_c.sort().values):
                    if not torch.equal(dense, dense_c):
                        raise Failed(f"compression topk {path}: same kept "
                                     f"set, other values")
                    continue
                # other kept sets: every entry kept on one side only ties
                # at the cut, and the rest is equal
                other_sets += 1
                cut = kept.abs().min().cpu()
                if cut != kept_c.abs().min():
                    raise Failed(f"compression topk {path}: cuts differ")
                mine = torch.zeros(x_cpu.numel(), dtype=torch.bool)
                mine[idx.cpu()] = True
                theirs = torch.zeros_like(mine)
                theirs[idx_c] = True
                differ = (mine ^ theirs).reshape(shape)
                ties += int(differ.sum())
                if not torch.equal(x_cpu.abs()[differ],
                                   cut.expand(int(differ.sum()))) or \
                        not torch.equal(dense[~differ], dense_c[~differ]):
                    raise Failed(f"compression topk {path}: the kept sets "
                                 f"differ beyond ties at the cut")
            del xs_cpu, on_cpu
            cpu_s = time.perf_counter() - t0
            detail = {"leaves": n_leaves,
                      "leaves_with_other_kept_set_on_cpu": other_sets,
                      "entries_swapped_at_tied_cut": ties,
                      "elsewhere": "bit-equal"}
        line("compression", method=method, card=repr(card_line),
             topk_ratio=TOPK_RATIO if method == "topk" else None,
             entries=n, wire_ratio=comp.compression_ratio(ccfg),
             update_ms=f"{update_ms:.3f}", compress_ms=f"{compress_ms:.3f}",
             sent_plus_residual="g + r bit for bit", cpu_s=f"{cpu_s:.2f}",
             **detail)
        del opt, state, residual, sent, res
        free_cuda()


def families_path(card_line: str, fa) -> tuple:
    """Phases 19-24: the moe and encoder-decoder families and gradient
    compression.  Returns the worst flash error against its plain version
    and the flash launch records of these paths."""
    torch.backends.cuda.matmul.allow_tf32 = False      # the router is float32
    free_cuda()
    records = moe_phase(card_line, fa)
    records += mixtral_phase(card_line, fa)
    records += encdec_phase(card_line, fa)
    grads, params = moe_train_phase(card_line, fa)
    compression_phase(card_line, grads, params)
    del grads, params
    free_cuda()
    worst = max(r["max_abs_err"] for r in records)
    line("flash-launches", records=json.dumps([
        {k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in r.items()}
        for r in records]))
    return worst, records


# ---------------------------------------------------------------------------
# distribution: the sharded steps on a 1 x 1 mesh, the dry run
# ---------------------------------------------------------------------------

MESH_PREFILL_BATCH = 2                 # x TRAIN_LEN tokens
MESH_DECODE_BATCH, MESH_DECODE_STEPS = 4, 32
MESH_REPS = 5                      # timed calls per side of each comparison
# the reference's dry-run test cells (tests/test_dryrun.py) and its largest
# dense decode, on the single 16 x 16 production mesh
DRYRUN_CELLS = (("mamba2-370m", "decode_32k"), ("mamba2-370m", "train_4k"),
                ("qwen2-72b", "decode_32k"))
DRYRUN_DIR = ROOT / "build" / "dryrun" / "chip_smoke"


def start_dryrun() -> list:
    """The dry run of each ``DRYRUN_CELLS`` cell, a CPU process each (a fake
    256-rank group, meta shards: no card), all started together once the
    timed phases are over, so that no host timing runs beside them;
    ``dryrun_phase`` waits for them, and any still running when this
    process exits are stopped."""
    import atexit
    import os

    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = DRYRUN_DIR / f"{arch}_{shape}.json"
        out.unlink(missing_ok=True)
        log = open(DRYRUN_DIR / f"{arch}_{shape}.log", "w")
        procs.append((arch, shape, out, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--out", str(out)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    atexit.register(_stop_dryrun, procs)
    return procs


def _stop_dryrun(procs: list) -> None:
    for *_, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def train_batch_bytes(arch: str, shape_name: str) -> int:
    """Per-device bytes of a train cell's batch on the single 16 x 16 mesh:
    the port's batch specs under the dry run's rules (ZeRO-3 cells, which
    shard the batch otherwise, are refused)."""
    import math

    from repro_torch.configs import SHAPES, get_config, input_specs
    from repro_torch.parallel import sharding as shd

    class Mesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    cfg = get_config(arch)
    if cfg.train_parallelism == "zero3":
        raise Failed(f"dryrun {arch}: a ZeRO-3 cell's batch is not counted")
    batch = input_specs(cfg, SHAPES[shape_name])
    specs = shd.batch_specs(cfg, Mesh, batch, shd.make_rules(cfg, Mesh))
    total = 0
    for name, leaf in batch.items():
        n = leaf.element_size()
        for d, size in enumerate(leaf.shape):
            entry = specs[name][d] if d < len(specs[name]) else None
            axes = entry if isinstance(entry, tuple) else (entry,) if entry else ()
            n *= size // math.prod(Mesh.shape[a] for a in axes)
        total += n
    return total


def dryrun_phase(card_line: str, procs: list) -> None:
    """Each cell's record: per-device argument, peak and temporary bytes
    against the card's memory, flops and fused bytes accessed with their
    roofline terms at the card's peaks, collective counts and bytes;
    ``train_4k`` held to the reference test's bars (tests/test_dryrun.py)
    and its bytes accessed to at least AdamW's writes (the new parameters
    and both moments: the argument bytes less the batch's)."""
    total_memory = torch.cuda.get_device_properties(0).total_memory
    try:
        for arch, shape, out, log, proc in procs:
            rc = proc.wait(timeout=900)
            log.close()
            if rc != 0:
                tail = pathlib.Path(log.name).read_text()[-2000:]
                raise Failed(f"dryrun {arch} x {shape}: rc {rc}\n{tail}")
            (rec,) = json.loads(out.read_text())
            c, mem = rec["collectives"], rec["memory"]
            model = 6 * rec["active_params"] * 4096 * 256 / rec["num_devices"]
            adamw_writes = (mem["argument_size_in_bytes"]
                            - train_batch_bytes(arch, shape)
                            if shape == "train_4k" else 0)
            line("dryrun", arch=arch, shape=shape, mesh=rec["mesh"],
                 num_devices=rec["num_devices"], trace_s=rec["trace_s"],
                 flops_per_device=f"{rec['flops']:.6e}",
                 flops_over_6nd=(f"{rec['flops'] / model:.4f}"
                                 if shape == "train_4k" else "n/a"),
                 bytes_accessed=f"{rec['bytes_accessed']:.6e}",
                 temp_bytes=mem["temp_size_in_bytes"],
                 flop_term_ms=f"{rec['flops'] / PEAK_BF16_FLOP_PER_S * 1e3:.6f}",
                 byte_term_ms=f"{rec['bytes_accessed'] / PEAK_BYTES_PER_S * 1e3:.6f}",
                 adamw_write_bytes=adamw_writes or "n/a",
                 collective_counts=json.dumps(
                     {k: int(v) for k, v in c["counts"].items()}),
                 collective_wire_bytes=json.dumps(
                     {k: int(v) for k, v in c["bytes"].items()}),
                 collective_total_bytes=f"{c['total_bytes']:.6e}",
                 argument_bytes=mem["argument_size_in_bytes"],
                 peak_bytes=mem["peak_size_in_bytes"],
                 card_total_memory=total_memory,
                 peak_share_of_card=f"{mem['peak_size_in_bytes'] / total_memory:.4f}",
                 card=repr(card_line))
            if (rec["num_devices"] != 256 or not rec["flops"] > 0
                    or not rec["bytes_accessed"] > 0
                    or not mem["temp_size_in_bytes"] > 0
                    or rec["bytes_accessed"] < adamw_writes):
                raise Failed(f"dryrun {arch} x {shape}: {rec}")
            if shape == "train_4k" and not (
                    c["counts"]["all-gather"] > 48 and c["total_bytes"] > 1e9
                    and 0.8 * model < rec["flops"] < 3.0 * model):
                raise Failed(f"dryrun {arch} x {shape}: outside the "
                             f"reference test's bars: {rec}")
    finally:
        _stop_dryrun(procs)


def _host(tree):
    """Every leaf of a (DTensor) tree whole, on the host."""
    from repro_torch.parallel.dtensor_ops import is_dtensor
    from repro_torch._tree import items

    return [(p, (t.full_tensor() if is_dtensor(t) else t).detach().cpu())
            for p, t in items(tree)]


def _max_abs(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
               for (_, x), (_, y) in zip(a, b))


def _bit_equal(a: list, b: list) -> bool:
    return [p for p, _ in a] == [p for p, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def mesh_steps_phase(card_line: str, fa, ssd) -> None:
    """deepseek-7b at its published widths, 2 of 30 layers (as [train]), on
    a 1 x 1 ("data", "model") NCCL mesh in this process, the production
    rules and the activation policy: the train step (bf16, 8 x 4096 in 4
    microbatches, AdamW), a 2 x 4096 prefill and 32 decode steps at batch 4
    with the cache placed by ``cache_specs``, each bit-equal to the same
    step without a mesh on the same seeded weights, and each step's wall
    time beside the unsharded step's: the median of ``MESH_REPS`` calls
    after the checked one and a warm-up (``wall_ms_median``), the decode
    step's over 31 steps after the first, which fills DTensor's
    propagation caches."""
    from repro_torch import spans
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import (ActivationPolicy,
                                                  activation_sharding)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        cfg = get_config(TRAIN_ARCH, num_layers=TRAIN_LAYERS)
        model = build_model(cfg, device="cuda")
        rules = shd.make_rules(cfg, mesh)
        policy = ActivationPolicy(mesh=mesh, batch_axes=rules.batch,
                                  tensor_axis=rules.tensor)
        place = lambda tree, specs: shd.distribute(tree,
                                                   shd.named_tree(mesh, specs))
        opt = adamw(AdamWConfig(learning_rate=3e-4))
        step = make_train_step(model, opt)
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                           global_batch=TRAIN_BATCH, device="cuda")
        batch = pipe.batch_at(0)
        params = model.init(0)
        pspecs = shd.param_specs(cfg, mesh, params, rules)
        spans.reset_counts()
        free_cuda()

        # the train step: unsharded, then on the mesh from the same state
        state = (params, opt.init(params))
        plain = step(*state, batch)
        plain_host = _host(plain[:2]) + [("loss", plain[2]["total_loss"].cpu())]
        del plain
        _, plain_ms = wall_ms_median(
            lambda: step(*state, batch)[2]["total_loss"], MESH_REPS)
        del state
        free_cuda()
        with activation_sharding(policy):
            dstate = (place(params, pspecs),
                      place(opt.init(params), shd.opt_specs(pspecs)))
            dbatch = place(batch, shd.batch_specs(cfg, mesh, batch, rules))
            sharded = step(*dstate, dbatch)
            sharded_host = _host(sharded[:2]) + [
                ("loss", sharded[2]["total_loss"].full_tensor().cpu())]
            del sharded
            _, mesh_ms = wall_ms_median(
                lambda: step(*dstate, dbatch)[2]["total_loss"], MESH_REPS)
        del dstate
        free_cuda()
        equal = _bit_equal(plain_host, sharded_host)
        line("mesh-steps", step="train", arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
             batch=TRAIN_BATCH, seq=TRAIN_LEN,
             microbatches=cfg.train_microbatches, mesh="1x1 nccl",
             bit_equal=equal, max_abs_diff=f"{_max_abs(plain_host, sharded_host):.6g}",
             reps=MESH_REPS, unsharded_ms_median=f"{plain_ms:.3f}",
             mesh_ms_median=f"{mesh_ms:.3f}",
             mesh_over_unsharded=f"{mesh_ms / plain_ms:.4f}",
             card=repr(card_line))
        if not equal:
            raise Failed("mesh-steps: the sharded train step differs")
        del plain_host, sharded_host

        # the prefill
        prefill = make_prefill_step(model)
        pbatch = {"tokens": batch["tokens"][:MESH_PREFILL_BATCH].contiguous()}
        want, pf_ms = wall_ms_median(lambda: prefill(params, pbatch), MESH_REPS)
        dparams = place(params, pspecs)
        with activation_sharding(policy):
            dpb = place(pbatch, shd.batch_specs(cfg, mesh, pbatch, rules))
            got, dpf_ms = wall_ms_median(lambda: prefill(dparams, dpb),
                                         MESH_REPS)
            got = got.full_tensor()
        equal = torch.equal(want, got)
        line("mesh-steps", step="prefill", batch=MESH_PREFILL_BATCH,
             seq=TRAIN_LEN, bit_equal=equal,
             max_abs_diff=f"{float((want.float() - got.float()).abs().max()):.6g}",
             reps=MESH_REPS, unsharded_ms_median=f"{pf_ms:.3f}",
             mesh_ms_median=f"{dpf_ms:.3f}",
             mesh_over_unsharded=f"{dpf_ms / pf_ms:.4f}", card=repr(card_line))
        if not equal:
            raise Failed("mesh-steps: the sharded prefill differs")
        del want, got
        free_cuda()

        # 32 greedy decode steps at batch 4
        serve = make_serve_step(model)
        first = batch["tokens"][:MESH_DECODE_BATCH, :1].contiguous()
        runs = []
        for sharded_run in (False, True):
            cache = model.init_cache(MESH_DECODE_BATCH, MESH_DECODE_STEPS)
            p, tok = (dparams, None) if sharded_run else (params, first)
            ctx = activation_sharding(policy) if sharded_run \
                else contextlib.nullcontext()
            with ctx:
                if sharded_run:
                    cache = place(cache, shd.cache_specs(
                        cfg, mesh, cache, MESH_DECODE_BATCH, rules))
                    tok = place({"tokens": first}, shd.batch_specs(
                        cfg, mesh, {"tokens": first}, rules))["tokens"]
                toks, times = [], []
                for t in range(MESH_DECODE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    nxt, cache = serve(p, cache, tok, t)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    toks.append(nxt.full_tensor() if sharded_run else nxt)
                    tok = nxt[:, None]
            runs.append((torch.stack(toks).cpu(), _host(cache), times))
        (t0_, c0, ms0), (t1_, c1, ms1) = runs
        equal = torch.equal(t0_, t1_) and _bit_equal(c0, c1)
        launches = fa.LAUNCHES["flash_attention"] + ssd.LAUNCHES["ssd_scan"]
        line("mesh-steps", step="decode", batch=MESH_DECODE_BATCH,
             steps=MESH_DECODE_STEPS, bit_equal=equal,
             cache_max_abs_diff=f"{_max_abs(c0, c1):.6g}",
             unsharded_step_ms_median=f"{statistics.median(ms0[1:]):.3f}",
             mesh_step_ms_median=f"{statistics.median(ms1[1:]):.3f}",
             first_step_ms=f"{ms0[0]:.3f}/{ms1[0]:.3f}",
             kernel_launches=launches, card=repr(card_line))
        if not equal:
            raise Failed("mesh-steps: the sharded decode differs")
        if launches:
            raise Failed(f"mesh-steps: {launches} kernel launches")
        del params, dparams, runs
    finally:
        dist.destroy_process_group()
        free_cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import failures, optimize, prng, sweep, topology
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

    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import gate_norm as gn
    from repro_torch.kernels import rms_norm as rn

    libraries = (rs.LIBRARY, fa.LIBRARY, ssd.LIBRARY, gn.LIBRARY, cc.LIBRARY,
                 rn.LIBRARY)
    t_build = time.perf_counter()
    _build.load_libraries(libraries)
    line("build", kernels=len(libraries),
         wall_seconds=f"{time.perf_counter() - t_build:.2f}", card=repr(card_line))
    for name, _, flags in libraries:
        info = _build.build_log[name]
        line("build", kernel=name, seconds=f"{info['seconds']:.2f}",
             cached=info["cached"], fmad=("-fmad=false" not in flags))
        for fn in ptxas_functions(info["ptxas"]):
            line("build", kernel=name, **fn)
            # no kernel spills; every survivor's carry in registers, so no
            # renewal kernel has a stack frame either
            if fn["spill_stores"] or fn["spill_loads"] or (
                    name == rs.LIBRARY[0] and fn["stack_frame"]):
                raise Failed(f"{fn['function']}: {fn['stack_frame']} bytes of "
                             f"stack frame, {fn['spill_stores']} of spill "
                             f"stores, {fn['spill_loads']} of spill loads")

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
    n_lev = scen_ops[2].shape[2]
    print_renewal_occupancy(rs, {
        "main-path": (len(scen), FULL_RUNS, n_surv, n_lev),
        "policy-grid": (len(table), FULL_RUNS, n_surv, n_lev),
        "weibull": (len(scen), WEIBULL_RUNS, n_surv, n_lev),
        **{"fleet-preset" if shape == FLEET_SHAPE else f"{shape[0]}x{shape[1]}":
           (len(scen), FULL_RUNS, *shape) for shape in WIDE_TIMED_SHAPES}})

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

    # --- phase 2b: 1-4 survivors (whose mapping follows the launch size) at
    # every ladder depth of the shallow kernels, warps and blocks
    # part-filled (R = 1, 31) and whole, both mappings of runs to lanes;
    # (felled, compensated) alternate over the shapes so each shape sees two
    # of the four and each (N, F) all four
    for n in range(1, SHAPES_MAX_N + 1):
        for nf in range(1, rs.FAST_MAX_F + 1):
            ops = with_shape(scen_ops, n, nf)
            shape_abs, shape_rel, seen, n_cases = shape_sweep(
                rs, failures, prng, ops, n, dev, key=100, seed=17,
                first=n + nf, forced=True)
            worst_abs = max(worst_abs, shape_abs)
            worst_rel = max(worst_rel, shape_rel)
            if len(seen) != 4:
                raise Failed(f"kernel-shapes n={n} nf={nf}: only {sorted(seen)}")
            line("kernel-shapes", survivors=n, levels=nf, lanes=ops[0].shape[0],
                 shapes="K,R=" + "/".join(f"{k}x{r}" for k, r in SHAPE_KR),
                 cases=n_cases, felled_compensated="all four",
                 lanes_per_run="auto/" + "/".join(map(str, rs.lane_choices(n))),
                 ints="exact",
                 max_abs_err=f"{shape_abs:.6g}")

    # --- phase 2c: more survivors and deeper ladders, the caps -------------
    b_abs, b_rel = kernel_bounds_phase(
        card_line, rs, failures, prng, scen_ops, dev, len(scen))
    worst_abs, worst_rel = max(worst_abs, b_abs), max(worst_rel, b_rel)

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
         kernel_ms=f"{k_ms:.5f}", earlier_kernel_ms=EARLIER_MAIN_PATH_MS,
         wrapper_host_ms=f"{host_ms:.5f}",
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
            process=proc, stats=True, engine="kernel"))
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

    # --- phases 5b, 5c: correlated rack failures, the process axis --------
    c_abs, c_rel = correlated_phase(card_line, rs, sweep, topology, failures,
                                    prng, scen, key, n_nodes)
    p_abs, p_rel = processes_phase(card_line, rs, sweep, failures, scen, key,
                                   n_nodes)
    worst_abs = max(worst_abs, c_abs, p_abs)
    worst_rel = max(worst_rel, c_rel, p_rel)

    table4_phase(card_line)
    sweep_phase(card_line, sweep, scen)
    monte_carlo_phase(card_line, sweep, prng, scen)
    renewal_f64_phase(card_line, sweep, optimize, scen, key, n_nodes, summaries,
                      res, grid_cfg, table, makespans)
    line("single-failure-done", seconds=f"{time.perf_counter() - t_start:.1f}")

    from repro_torch import fleet

    o_abs, o_rel = optimize_phase(card_line, rs, sweep, optimize, grid_cfg,
                                  table, makespans, key)
    worst_abs, worst_rel = max(worst_abs, o_abs), max(worst_rel, o_rel)
    fleet_phase(card_line, rs, sweep, optimize, fleet, key)
    campaign_phase(card_line, sweep, prng)
    line("operator-done", seconds=f"{time.perf_counter() - t_start:.1f}")

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
    published = published_zamba2_phase(card_line, fa, ssd)
    gate_norm_phase(card_line)
    causal_conv_phase(card_line)
    rms_norm_phase(card_line)
    for rec in lm_records:
        rec["published"] = published[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 published[rec["name"]]["max_abs_err"])
    line("lm-done", seconds=f"{time.perf_counter() - t_start:.1f}")
    dense_err = training_path(card_line, fa, ssd)
    line("train-done", seconds=f"{time.perf_counter() - t_start:.1f}")
    family_err, _ = families_path(card_line, fa)
    lm_records[0]["max_abs_err"] = max(lm_records[0]["max_abs_err"], dense_err,
                                       family_err)
    mesh_steps_phase(card_line, fa, ssd)
    line("mesh-steps-done", seconds=f"{time.perf_counter() - t_start:.1f}")
    # the dry run needs no card: its CPU processes start after every timing
    dryrun_phase(card_line, start_dryrun())
    line("mesh-done", seconds=f"{time.perf_counter() - t_start:.1f}")
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
