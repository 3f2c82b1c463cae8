"""One run of one cell: set-up, the measured window, the check.

Set-up builds the port's model from the configuration, makes the weights
and every batch of the mix from the seed on the device, and warms up on the
cell's own shape.  The window is a closed loop with one batch in flight:
a prefill ends when its last-position logits are on the host, and the
window ends with the first prefill that ends past ``seconds``.  The rate is
every prompt token of the completed prefills over the time from the
window's start to that prefill's end.

With ``trace``, ``torch.profiler`` records two steady parts of the window
(``lib/trace.py``), each of the prefills until ``TRACE_SECONDS`` have
passed: first with CUDA activity alone (the device's operations, times and
idle share, undisturbed by the profiler's host work), then with the CPU's
operators too (where each kernel was launched from, and what the host did
while the device idled).  One profiled prefill in set-up starts the
profiler's own machinery.  The per-layer readers take their numbers from
these parts; the end-to-end metrics are not reported then.

After the window the peak memory is read, the program's state is freed and
the reference runs on a sample of the window's prefills drawn from the
seed: the numbers of ``lib.check`` beside the cell's limits decide
``correct``.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench.lib import check, spec
from portbench.lib import trace as tracemod
from portbench.lib.traffic import make_pool, sub_seed
from portbench.lib.weights import shapes

WARMUP_PREFILLS = 2
TRACE_SECONDS = 2.0
WINDOW_RANGE = "portbench.window"
WEIGHT_STREAM, SAMPLE_STREAM = 0, 2


class TraceContext:
    """What a per-layer reader is handed: the device trace, the host trace
    and the configuration's work of one prefill."""

    def __init__(self, trace: tracemod.Trace, host: tracemod.Trace,
                 work: dict):
        self.trace, self.host, self.work = trace, host, work
        self.prefills = trace.prefills


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell: spec.Cell, seed: int, device: torch.device, dims: dict):
    """The program's prefill step and the run's weights."""
    from repro_torch.launch import steps
    from repro_torch.models import build_model, transformer

    cfg = cell.config.port_config(dims)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHT_STREAM))
    weights = cell.config.make_weights(dims, gen, device)
    want, got = shapes(transformer.abstract_params(cfg)), shapes(weights)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"weights differ from the port's tree: {diff[:6]}")
    model = build_model(cfg, device=device)
    return steps.make_prefill_step(model), weights


def _activities(device: torch.device, host: bool) -> list:
    """CUDA activity, with the CPU's where ``host`` (or off the card)."""
    acts = [torch.profiler.ProfilerActivity.CPU] \
        if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def window(step, weights: dict, pool: torch.Tensor, seconds: float,
           device: torch.device, trace: bool = False):
    """The closed loop.  Returns (host logits per prefill, elapsed seconds,
    the device trace's and the host trace's events and prefills)."""
    outs, traces, i = [], [], 0
    n_pool = pool.shape[0]

    def one():
        nonlocal i
        out = step(weights, {"tokens": pool[i % n_pool]}).cpu()
        outs.append(out)
        i += 1

    def traced(host: bool):
        n = 0
        # the host trace's window is its range; the device trace has no
        # host events, so no range: its window is its operations' span
        with torch.profiler.profile(activities=_activities(device, host)) as prof:
            with (torch.profiler.record_function(WINDOW_RANGE) if host
                  else contextlib.nullcontext()):
                t_trace = time.perf_counter()
                while time.perf_counter() - t_trace < TRACE_SECONDS or n < 2:
                    one()
                    n += 1
                _sync(device)
        traces.append((tracemod.events_of(prof), n))

    _sync(device)
    t0 = time.perf_counter()
    if trace:
        traced(host=False)
        traced(host=True)
    while time.perf_counter() - t0 < seconds:
        one()
    return outs, time.perf_counter() - t0, traces


def reference(cell: spec.Cell, weights: dict, tokens: torch.Tensor,
              dims: dict, precision: str = "fp32"):
    """The reference's last-position logits (rows, vocab) on the host, and,
    where the limits give a ``tie_margin``, each row's least router margin
    at the last position over the layers (else None)."""
    if cell.limits.get("tie_margin") is None:
        out = cell.reference.forward(weights, tokens, dims, precision)
        return out.cpu().numpy(), None
    margins: list = []
    out = cell.reference.forward(weights, tokens, dims, precision, margins=margins)
    return out.cpu().numpy(), torch.stack(margins).min(0).values.cpu().numpy()


def kept_rows(limits: dict, margins: list) -> np.ndarray:
    """Which rows count in the worst-prompt numbers: those whose routes are
    no near tie (every row where the limits give no ``tie_margin``)."""
    return np.concatenate([np.ones(len(r), dtype=bool) if m is None
                           else m >= limits["tie_margin"] for r, m in margins])


def checked(limits: dict, n_prefills: int, batch: int, seed: int) -> list:
    """The window's prefills and prompts the reference checks, drawn from
    the seed: ``sample_prefills`` of the prefills, and of each the
    ``sample_prompts`` (every prompt where the limits do not say)."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE_STREAM))
    k = min(int(limits["sample_prefills"]), n_prefills)
    n = min(int(limits.get("sample_prompts", batch)), batch)
    return [(i, torch.from_numpy(np.sort(rng.choice(batch, size=n, replace=False))))
            for i in sorted(rng.choice(n_prefills, size=k, replace=False).tolist())]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        started: float, device: str = "cuda", dims: Optional[dict] = None,
        mix: Optional[dict] = None) -> dict:
    """One run; returns the result line's keys (``checks`` last).
    ``dims`` and ``mix`` replace the configuration's sizes and the cell's
    mix (the CPU tests run the same path at a small size)."""
    dev = torch.device(device)
    dims = cell.config.dims(cell.config_doc) if dims is None else dims
    mix = cell.traffic if mix is None else mix
    stages = [("imports", time.time())]
    step, weights = build(cell, seed, dev, dims)
    pool = make_pool(mix, dims["vocab"], seed, dev)
    _sync(dev)
    stages.append(("weights_and_ids", time.time()))
    for i in range(WARMUP_PREFILLS):
        step(weights, {"tokens": pool[i % pool.shape[0]]}).cpu()
    if trace:
        with torch.profiler.profile(activities=_activities(dev, True)):
            step(weights, {"tokens": pool[0]}).cpu()
    _sync(dev)
    stages.append(("warm_up", time.time()))
    setup_s = stages[-1][1] - started
    at = started
    for name, t in stages:
        print(f"setup {name}_s={t - at!r}", file=sys.stderr)
        at = t

    outs, elapsed, traces = window(step, weights, pool, seconds, dev, trace)
    batch, seq = pool.shape[1], pool.shape[2]

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type, "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0}
    del step                                  # the program's state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        device_info["power_limit_w"] = power_limit_w()

    metrics, breakdown = {}, None
    if trace:
        (dev_events, dev_n), (host_events, host_n) = traces
        tr = tracemod.reduce_device(dev_events, dev_n)
        host = tracemod.reduce(host_events, WINDOW_RANGE, host_n)
        del traces, dev_events, host_events
        ctx = TraceContext(tr, host, cell.config.work(dims, batch, seq))
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(10),
                     "idle_gaps": host.idle_by_host(10)}
    else:
        metrics["prefill_tokens_per_s"] = {
            "value": len(outs) * batch * seq / elapsed, "unit": "tokens/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        known = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in known}

    vocab = dims["vocab"]
    sample = checked(cell.limits, len(outs), batch, seed)
    got = np.concatenate([outs[i][rows, :vocab].numpy() for i, rows in sample])
    refs = [reference(cell, weights, pool[i % pool.shape[0]][rows], dims)
            for i, rows in sample]
    ref = np.concatenate([r for r, _ in refs])
    kept = kept_rows(cell.limits, refs)
    print(f"check prompts={len(kept)} near_ties_left_out={int((~kept).sum())}",
          file=sys.stderr)
    checks, failed = check.judge(got, ref, cell.limits["limits"], kept)
    result = {"correct": failed == 0, "attempted": len(outs) * batch,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
