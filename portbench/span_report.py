"""Where a cell's device time goes, by the program's spans, and what the
spans cost when they record.  On the card, from the checkout's root:

    python3 portbench/span_report.py --workload mixtral-8x22b.prefill-2x8192 --seed 2147483651

Builds the cell as ``portbench/run.py`` does, warms up, then traces the
closed loop as a ``--trace 1`` run does (``lib/runner.py``'s ``window``:
CUDA activity alone, then with the CPU's operators) in rounds, spans on
(the host trace's profiler switches them on) and off
(``repro_torch.spans.off()``), in the order on, off, off, on.  Prints one JSON line a round
(``cost``: the host trace's wall time a prefill and idle share, the device
trace's operations a prefill, which spans a CUDA-only trace holds), then
one of the spans-on host trace (``report``): device seconds by innermost
span (``lib/spans.py``), the idle gaps by what the host ran, the share of
device time launched inside a span, where the SSD, flash and expert
``bmm`` kernels fell, the counters' change over the traced prefills and
the per-layer readers of this benchmark.  The same lines go to
``chiprun_out/span_report.<cell>.jsonl``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernels_of(found, names):
    """{span: device seconds} of the operations whose name holds one of
    ``names``."""
    out: dict = {}
    for op, span in found:
        if any(n in op.name for n in names):
            out[str(span)] = out.get(str(span), 0.0) + (op.end - op.start) / 1e9
    return out


def report(cell, ctx, delta: dict) -> dict:
    from portbench.lib import spans as lspans
    from portbench.lib import spec

    host = ctx.host
    found = lspans.attribute(host)
    out = {"kind": "report", "cell": cell.name, "prefills": host.prefills,
           "counters_delta": delta}
    if found is None:
        pairs = lspans.pair_launches(host)
        launches = [e for e in host.host if e.kind in
                    ("cuda_runtime", "cuda_driver")]
        out["attribution"] = "failed"
        out["paired"] = pairs is not None
        out["ops_by_kind"] = {k: sum(1 for o in host.ops if o.kind == k)
                              for k in ("kernel", "gpu_memcpy", "gpu_memset")}
        out["launch_names"] = sorted({e.name for e in launches})
        out["launches_by_kind"] = {
            k: sum(1 for e in launches if lspans.enqueued_kind(e.name) == k)
            for k in ("kernel", "gpu_memcpy", "gpu_memset")}
        return out
    total = sum(op.end - op.start for op, _ in found)
    in_span = sum(op.end - op.start for op, s in found if s is not None)
    out["device_s"] = total / 1e9
    out["share_in_a_span"] = in_span / total
    out["by_span"] = lspans.by_span(host, 20)
    out["idle_by_host"] = host.idle_by_host(12)
    out["outside_spans"] = sorted({op.name[:60] for op, s in found if s is None})
    ssd = spec.metric_reader("ssd_scan_roofline.prefill").KERNELS
    flash = spec.metric_reader("flash_attention_roofline.prefill").KERNELS
    out["ssd_kernels_by_span"] = _kernels_of(found, ssd)
    out["flash_kernels_by_span"] = _kernels_of(found, flash)
    # the launches inside an aten::bmm, by span: the experts' grouped matmuls
    cpu_ops = [e for e in host.host if e.kind == "cpu_op"]
    pairs = lspans.pair_launches(host)
    ops_at = lspans.innermost([call.start for _, call in pairs], cpu_ops)
    span_of = {id(op): s for op, s in found}
    bmm: dict = {}
    for (op, _), aten in zip(pairs, ops_at):
        if aten == "aten::bmm":
            key = str(span_of[id(op)])
            bmm[key] = bmm.get(key, 0.0) + (op.end - op.start) / 1e9
    out["bmm_by_span"] = bmm
    prefills = [e for e in host.host if e.name == "prefill"]
    if prefills:
        out["prefill_span_host_s"] = sum(e.end - e.start for e in prefills) \
            / len(prefills) / 1e9
    out["readers"] = {m["name"]: spec.metric_reader(m["name"]).read(ctx)
                      for m in cell.per_layer}
    return out


def _share_idle(t) -> float | None:
    return 1.0 - t.busy_s / t.window_s if t.window_s > 0 else None


def measure(cell, seed: int, device: str = "cuda", dims=None, mix=None
            ) -> list:
    """The cost lines of the four rounds and the report of the first
    spans-on round.  ``dims`` and ``mix`` replace the configuration's
    sizes and the cell's mix (the CPU tests run it small)."""
    import torch

    from portbench.lib import runner
    from portbench.lib import trace as tracemod
    from portbench.lib.traffic import make_pool
    from repro_torch import spans

    dev = torch.device(device)
    dims = cell.config.dims(cell.config_doc) if dims is None else dims
    mix = cell.traffic if mix is None else mix
    step, weights = runner.build(cell, seed, dev, dims)
    pool = make_pool(mix, dims["vocab"], seed, dev)
    batch, seq = pool.shape[1], pool.shape[2]
    for i in range(runner.WARMUP_PREFILLS):
        step(weights, {"tokens": pool[i % pool.shape[0]]}).cpu()
    with torch.profiler.profile(activities=runner._activities(dev, True)):
        step(weights, {"tokens": pool[0]}).cpu()
    runner._sync(dev)
    names = set(spans.NAMES)
    lines, kept = [], None
    for label in ("on", "off", "off", "on"):
        before = spans.counts()
        with spans.off() if label == "off" else contextlib.nullcontext():
            t = time.perf_counter()
            _, _, traces = runner.window(step, weights, pool, 0.0, dev,
                                         trace=True)
            wall = time.perf_counter() - t
        after = spans.counts()
        (dev_events, dev_n), (host_events, host_n) = traces
        tr = tracemod.reduce_device(dev_events, dev_n)
        host = tracemod.reduce(host_events, runner.WINDOW_RANGE, host_n)
        lines.append({
            "kind": "cost", "cell": cell.name, "spans": label,
            "host_trace_s_per_prefill": host.window_s / host.prefills,
            "host_trace_idle_share": _share_idle(host),
            "host_trace_prefills": host.prefills,
            "device_trace_ops_per_prefill": tr.count() / tr.prefills,
            "device_trace_idle_share": _share_idle(tr),
            "device_trace_span_events": sum(1 for e in dev_events
                                            if e.name in names),
            "host_trace_span_events": sum(1 for e in host_events
                                          if e.name in names
                                          and not e.on_device),
            "both_traces_wall_s": wall,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type,
            "power_limit_w": runner.power_limit_w() if dev.type == "cuda"
            else None})
        if label == "on" and kept is None:
            delta = {k: after[k] - before.get(k, 0) for k in after}
            kept = (runner.TraceContext(tr, host, cell.config.work(
                dims, batch, seq)), delta)
        del traces, dev_events, host_events
    lines.append(report(cell, *kept))
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run as entry
    entry.prepare()

    import torch

    from portbench.lib import spec

    if not torch.cuda.is_available():
        print("no CUDA device: the report runs on the card only",
              file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lines = measure(cell, args.seed)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", f"span_report.{cell.name}.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    for x in lines:
        print(json.dumps(x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
