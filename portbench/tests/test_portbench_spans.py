"""The program's spans in the harness, on the CPU: each device operation
put down to the innermost span around its launch (``lib/spans.py``), the
idle gaps named by the span the host was in, the three readers of the
spans and the MoE row counter, and the spans a traced run of each small
cell records.  On a hand-made trace, the readers that were there read the
same with and without span events."""
import sys
import time

import pytest

from _small import CELLS, small
from portbench.lib import runner, spec
from portbench.lib import spans as lspans
from portbench.lib import trace as tr

SEED = 2**31 + 11
E = tr.Event
NEW = ("moe_routing_share.prefill", "moe_expert_row_use.prefill",
       "ssm_glue_share.prefill")


def _events(family="moe", children=("moe.router", "moe.dispatch",
                                    "moe.experts")):
    """Three kernels launched inside three child spans of ``family`` in a
    ``prefill`` span, and the logits' copy launched outside every span."""
    a, b, c = children
    return [
        E("portbench.window", "user_annotation", False, 0, 1000, 0, 1),
        E("prefill", "user_annotation", False, 5, 700, 0, 1),
        E(family, "user_annotation", False, 8, 500, 0, 1),
        E(a, "user_annotation", False, 9, 45, 0, 1),
        E("aten::mm", "cpu_op", False, 10, 40, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 20, 25, 7, 99),
        E(b, "user_annotation", False, 48, 62, 0, 1),
        E("aten::add", "cpu_op", False, 50, 60, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 52, 55, 8, 99),
        E(c, "user_annotation", False, 65, 80, 0, 1),
        E("cudaLaunchKernelExC", "cuda_runtime", False, 70, 75, 9, 99),
        E("aten::copy_", "cpu_op", False, 705, 990, 0, 1),
        E("cudaMemcpyAsync", "cuda_runtime", False, 710, 720, 10, 99),
        E("cudaStreamSynchronize", "cuda_runtime", False, 730, 990, 0, 99),
        E("sm90_xmma_gemm_bf16", "kernel", True, 100, 300, 7),
        E("elementwise_kernel", "kernel", True, 300, 400, 8),
        E("flash_wgmma_kernel<112>", "kernel", True, 500, 600, 9),
        E("Memcpy DtoH", "gpu_memcpy", True, 900, 950, 10),
    ]


def _ctx(events):
    t = tr.reduce(events, "portbench.window", prefills=2)
    work = {"flop": 1e6, "matmul_flop": 4e5, "flash": [(1e5, 2e3)] * 3,
            "ssd": [(1e5, 2e3)] * 3}
    return runner.TraceContext(t, t, work)


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_each_operation_goes_to_the_innermost_span_of_its_launch():
    host = _ctx(_events()).host
    found = lspans.attribute(host)
    assert [(op.name, span) for op, span in found] == [
        ("sm90_xmma_gemm_bf16", "moe.router"),
        ("elementwise_kernel", "moe.dispatch"),
        ("flash_wgmma_kernel<112>", "moe.experts"),
        ("Memcpy DtoH", None)]
    assert lspans.by_span(host) == [
        ["moe.router", pytest.approx(200e-9)],
        ["moe.dispatch", pytest.approx(100e-9)],
        ["moe.experts", pytest.approx(100e-9)],
        [lspans.NO_SPAN, pytest.approx(50e-9)]]
    assert lspans.by_span(host, 1) == [["moe.router", pytest.approx(200e-9)]]


def test_innermost_range_of_nested_ranges():
    ranges = [E("a", "user_annotation", False, 0, 100),
              E("a.b", "user_annotation", False, 10, 50),
              E("a.c", "user_annotation", False, 60, 70),
              E("d", "user_annotation", False, 200, 300)]
    times = [150, 5, 20, 55, 65, 250, 70, 301]
    assert lspans.innermost(times, ranges) == [None, "a", "a.b", "a", "a.c",
                                               "d", "a.c", None]


def test_idle_gaps_are_named_by_the_span_the_host_was_in():
    t = _ctx(_events()).host
    idle = dict(t.idle_by_host())
    # the device idles 400-500 while the host runs Python inside ``moe``
    assert idle["moe"] == pytest.approx(100e-9)
    assert "(no host op)" not in idle
    bare = _ctx([e for e in _events() if e.name not in
                 lspans.program_span_names()]).host
    assert dict(bare.idle_by_host())["(no host op)"] == pytest.approx(100e-9)


def test_pairing_that_does_not_hold_reads_nothing():
    events = _events()
    # a kernel launch the trace lost: the counts differ
    lost = [e for e in events if not (e.kind == "cuda_runtime"
                                      and e.correlation == 8)]
    assert lspans.attribute(_ctx(lost).host) is None
    # the correlation ids say the first kernel came from outside every
    # operator, the order pairs it with a launch inside ``aten::mm``
    swapped = [E(e.name, e.kind, e.on_device, e.start, e.end,
                 {7: 9, 9: 7}.get(e.correlation, e.correlation), e.thread)
               if e.on_device else e for e in events]
    assert lspans.attribute(_ctx(swapped).host) is None
    assert lspans.enqueued_kind("cuLaunchKernelEx") == "kernel"
    assert lspans.enqueued_kind("cudaMemsetAsync") == "gpu_memset"
    assert lspans.enqueued_kind("cudaStreamSynchronize") is None


def _by_correlation(events):
    """Each device operation's span as the correlation ids give it: the
    innermost span around the launch with the operation's id."""
    names = lspans.program_span_names()
    ranges = [e for e in events if not e.on_device and e.name in names]
    launch = {e.correlation: e.start for e in events
              if e.kind in tr.LAUNCH_KINDS}
    ops = sorted((e for e in events if e.on_device), key=lambda e: e.start)
    spans = lspans.innermost([launch[e.correlation] for e in ops], ranges)
    return [(e.name, span) for e, span in zip(ops, spans)]


def _agrees_or_reads_nothing(events):
    found = lspans.attribute(_ctx(events).host)
    if found is None:
        return None
    assert [(op.name, span) for op, span in found] == \
        _by_correlation(events)
    return found


def _moved(events, times, extra=()):
    """The events with device operations moved to other times (a second
    stream), by correlation id, and more events."""
    out = [E(e.name, e.kind, e.on_device, *times[e.correlation],
             e.correlation, e.thread)
           if e.on_device and e.correlation in times else e for e in events]
    return sorted(out + list(extra), key=lambda e: (e.on_device, e.start))


def test_pairing_agrees_with_the_correlation_ids_or_reads_nothing():
    events = _events()
    # one stream: the pairing holds and agrees
    assert _agrees_or_reads_nothing(events) is not None
    # a second stream that waits for the first: the dispatch's kernel runs
    # before the router's, both launched inside an operator
    waits = _moved(events, {8: (100, 200), 7: (200, 400)}, [
        E("cudaStreamWaitEvent", "cuda_runtime", False, 30, 31, 0, 99)])
    assert _by_correlation(waits)[0] == ("elementwise_kernel",
                                         "moe.dispatch")
    assert _agrees_or_reads_nothing(waits) is None
    # a memset on a second stream runs beside the router's kernel: the
    # kinds come out of their launch order
    memset = _moved(events, {}, [
        E("cudaMemsetAsync", "cuda_runtime", False, 56, 57, 11, 99),
        E("Memset (Device)", "gpu_memset", True, 110, 120, 11)])
    assert _agrees_or_reads_nothing(memset) is None
    # the experts' kernel (launched outside every operator) runs beside
    # the router's on a second stream, ahead of the dispatch's
    beside = _moved(events, {9: (150, 250)})
    assert _by_correlation(beside)[1] == ("flash_wgmma_kernel<112>",
                                          "moe.experts")
    assert _agrees_or_reads_nothing(beside) is None
    # the dispatch's kernel on a second stream runs beside the router's,
    # which a kernel of the first stream held back: same kind, both
    # launched inside an operator
    held = _moved(events, {8: (100, 200), 7: (150, 350)}, [
        E("cudaLaunchKernel", "cuda_runtime", False, 15, 16, 12, 99),
        E("void fill_kernel", "kernel", True, 40, 150, 12)])
    assert _by_correlation(held)[1] == ("elementwise_kernel", "moe.dispatch")
    assert _agrees_or_reads_nothing(held) is None


def test_a_dropped_record_leaves_out_its_prefill_alone():
    one = [e for e in _events() if e.name != "portbench.window"]
    two = [E(e.name, e.kind, e.on_device, e.start + 1000, e.end + 1000,
             e.correlation and e.correlation + 100, e.thread) for e in one]
    events = [E("portbench.window", "user_annotation", False, 0, 2000, 0,
                1)] + one + two
    assert len(_agrees_or_reads_nothing(events)) == 8
    # the profiler dropped the first prefill's second kernel: the second
    # prefill is read alone, as the correlation ids give it
    dropped = [e for e in events if not (e.on_device and e.correlation == 8)]
    found = lspans.attribute(_ctx(dropped).host)
    assert [(op.name, span) for op, span in found] == \
        _by_correlation(dropped)[3:]
    assert _read("moe_routing_share.prefill", _ctx(dropped)) == \
        pytest.approx(300 / 450)
    # both prefills dropped one: nothing is read
    both = [e for e in dropped if not (e.on_device and e.correlation == 108)]
    assert lspans.attribute(_ctx(both).host) is None


def test_readers_that_were_there_read_the_same_with_spans():
    with_spans = _ctx(_events())
    without = _ctx([e for e in _events()
                    if e.name not in lspans.program_span_names()])
    for m in spec.benchmark()["per_layer"]:
        if m["name"] in NEW:
            continue
        assert _read(m["name"], with_spans) == _read(m["name"], without), \
            m["name"]


def test_new_readers_on_a_hand_made_trace():
    moe_ctx = _ctx(_events())
    assert _read("moe_routing_share.prefill", moe_ctx) == \
        pytest.approx(300 / 450)
    assert _read("ssm_glue_share.prefill", moe_ctx) is None
    ssm_ctx = _ctx(_events("ssm", ("ssm.conv", "ssm.scan", "ssm.gate_norm")))
    # of the three: a matmul, an elementwise kernel (glue), a kernel of the
    # port's own (launched outside every operator)
    assert _read("ssm_glue_share.prefill", ssm_ctx) == \
        pytest.approx(100 / 450)
    assert _read("moe_routing_share.prefill", ssm_ctx) is None
    # the glue counted is glue_share's, inside ``ssm``
    assert _read("ssm_glue_share.prefill", ssm_ctx) <= \
        _read("glue_share.prefill", ssm_ctx)
    bare = _ctx([e for e in _events()
                 if e.name not in lspans.program_span_names()])
    assert all(_read(name, bare) is None
               for name in ("moe_routing_share.prefill",
                            "ssm_glue_share.prefill"))


def test_row_use_reads_the_counters():
    from repro_torch.models import moe

    ctx = _ctx(_events())
    moe.reset_row_counts()
    try:
        assert _read("moe_expert_row_use.prefill", ctx) is None
        moe._count_rows(2 * 8192 * 2, 8 * 8192 * 2)
        assert _read("moe_expert_row_use.prefill", ctx) == 0.25
    finally:
        moe.reset_row_counts()


def test_new_readers_read_nothing_from_a_port_without_spans(monkeypatch):
    """A port without ``repro_torch.spans`` (the commit before them)."""
    import repro_torch
    from repro_torch.models import moe

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    ctx = _ctx(_events())
    moe._count_rows(4, 16)
    try:
        assert lspans.program_span_names() is None
        assert all(_read(name, ctx) is None for name in NEW)
    finally:
        moe.reset_row_counts()


WANT = {"mixtral-8x22b.prefill-2x8192": {
            "prefill", "embed", "head", "attn", "attn.flash", "moe",
            "moe.router", "moe.dispatch", "moe.experts", "moe.combine"},
        "mamba2-2.7b.prefill-16x4096": {
            "prefill", "embed", "head", "ssm", "ssm.conv", "ssm.scan",
            "ssm.gate_norm"}}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_records_every_span_of_the_cell(name, monkeypatch):
    captured = []
    reduce = tr.reduce

    def keep(events, window, prefills):
        captured.append(list(events))
        return reduce(events, window, prefills)

    monkeypatch.setattr(runner.tracemod, "reduce", keep)
    cell, dims, mix = small(name)
    result = runner.run(cell, SEED, 0.3, True, started=time.time(),
                        device="cpu", dims=dims, mix=mix)
    assert result["correct"] is True
    (events,) = captured
    names = {e.name for e in events if not e.on_device}
    assert names & set(lspans.program_span_names()) == WANT[name]
    # the CPU has no device operations: the new readers read nothing
    assert not set(result["metrics"]) & {"moe_routing_share.prefill",
                                         "ssm_glue_share.prefill"}


def test_span_report_on_the_cpu():
    from portbench import span_report

    cell, dims, mix = small("mixtral-8x22b.prefill-2x8192")
    lines = span_report.measure(cell, SEED, "cpu", dims, mix)
    cost = [x for x in lines if x["kind"] == "cost"]
    assert [x["spans"] for x in cost] == ["on", "off", "off", "on"]
    assert all((x["host_trace_span_events"] > 0) == (x["spans"] == "on")
               for x in cost)
    (rep,) = [x for x in lines if x["kind"] == "report"]
    # every routed pair of the traced prefills, a quarter of the rows
    assert rep["counters_delta"]["moe.computed"] > 0
    assert rep["counters_delta"]["moe.routed"] * 4 == \
        rep["counters_delta"]["moe.computed"]
