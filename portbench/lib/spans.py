"""Device time by the program's span that launched it, read from the host
trace (``lib/trace.py``'s ``reduce``).

The program marks the parts of its prefill as ``record_function`` ranges
(``repro_torch.spans``), recorded on the host trace's thread and clock.  A
device operation belongs to the innermost span that holds its launch.
``trace.DeviceOp`` carries no correlation id, so each operation is paired
with its launch by order: the prefill runs on one stream, where the card
runs operations in the order they were enqueued, so the k-th device
operation of the trace is the k-th launch, of the same kind (kernel, copy
or memset).  The pairing is checked against what ``reduce`` took from the
correlation ids: every operation's ``in_aten`` has to equal whether its
paired launch lies inside a PyTorch operator.  A trace with more than one
stream at work is not paired, as there the card may run a later launch
first: one in which a stream waits for another (``WAITS``), or two device
operations overlap in time (one stream runs one at a time).  The profiler
now and then drops a device operation's record, so the pairing is made
between the host's synchronisations (each prefill ends with one), and a
stretch whose operations and launches differ in number is left out.  Where
a check fails, no stretch is left or the program records no spans (a port
before them), nothing is read: ``None``.  Not seen: two streams that never
wait for each other and never overlap, running operations of one kind
launched alike (both inside or both outside an operator) out of their
launch order.  Pairing by correlation id in ``reduce`` would see it.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from portbench.lib.trace import (LAUNCH_KINDS, DeviceOp, Event, Trace, _inside,
                                 _merge)

NO_SPAN = "(no span)"
# the part of a CUDA API call's name that says what it enqueues
ENQUEUES = (("Memcpy", "gpu_memcpy"), ("Memset", "gpu_memset"),
            ("Launch", "kernel"))
# the part of the name of a CUDA API call that makes a stream wait for
# another stream's work
WAITS = ("StreamWaitEvent", "StreamWaitValue")
# the part of the name of a CUDA API call that waits for the device's work
SYNCS = "Synchronize"


def program_span_names() -> Optional[frozenset]:
    """The span names the program records, None for a port without them."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return frozenset(spans.NAMES)


def enqueued_kind(name: str) -> Optional[str]:
    """The device operation a CUDA API call enqueues, by its name."""
    return next((kind for part, kind in ENQUEUES if part in name), None)


def innermost(times: Sequence[int], ranges: Iterable[Event]
              ) -> List[Optional[str]]:
    """The name of the innermost range holding each time (None outside
    every range); the ranges nest, as one thread's ``record_function``
    ranges do."""
    ranges = sorted(ranges, key=lambda e: (e.start, -e.end))
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Event] = []
    i = 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while i < len(ranges) and ranges[i].start <= t:
            while stack and stack[-1].end < ranges[i].start:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[j] = stack[-1].name if stack else None
    return out


def pair_launches(host: Trace) -> Optional[List[Tuple[DeviceOp, Event]]]:
    """Each device operation of the host trace with its launch, paired in
    the order both happened between the host's synchronisations and
    checked against the kinds and ``in_aten``; a stretch whose counts
    differ is left out; None where the pairing does not hold."""
    calls = sorted((e for e in host.host if e.kind in LAUNCH_KINDS),
                   key=lambda e: e.start)
    ops = sorted(host.ops, key=lambda o: o.start)
    if any(w in e.name for e in calls for w in WAITS) \
            or any(a.end > b.start for a, b in zip(ops, ops[1:])):
        return None
    launches = [e for e in calls if enqueued_kind(e.name) is not None]
    ends = sorted(e.end for e in calls if SYNCS in e.name)
    stretch_ops: dict = {}
    stretch_launches: dict = {}
    for op in ops:
        stretch_ops.setdefault(bisect.bisect(ends, op.start), []).append(op)
    for call in launches:
        stretch_launches.setdefault(bisect.bisect(ends, call.start),
                                    []).append(call)
    aten = _merge((e.start, e.end) for e in host.host if e.kind == "cpu_op")
    pairs = []
    for k, found in sorted(stretch_ops.items()):
        enqueued = stretch_launches.get(k, [])
        if len(found) != len(enqueued):
            continue                     # a record the profiler dropped
        pairs += zip(found, enqueued)
    if not pairs or any(op.kind != enqueued_kind(call.name)
                        or op.in_aten is None
                        or op.in_aten != _inside(call.start, aten)
                        for op, call in pairs):
        return None
    return pairs


def attribute(host: Trace) -> Optional[List[Tuple[DeviceOp, Optional[str]]]]:
    """Each device operation of the host trace with the innermost program
    span around its launch (None: launched outside every span); None where
    the trace holds no span or the pairing fails."""
    names = program_span_names()
    if names is None or not host.ops:
        return None
    ranges = [e for e in host.host if not e.on_device and e.name in names]
    if not ranges:
        return None
    pairs = pair_launches(host)
    if pairs is None:
        return None
    spans = innermost([call.start for _, call in pairs], ranges)
    return [(op, name) for (op, _), name in zip(pairs, spans)]


def by_span(host: Trace, n: int = 12) -> Optional[List[list]]:
    """Device seconds by innermost span, largest first (``NO_SPAN`` for
    operations launched outside every span)."""
    found = attribute(host)
    if found is None:
        return None
    total: dict = {}
    for op, name in found:
        key = NO_SPAN if name is None else name
        total[key] = total.get(key, 0) + (op.end - op.start)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def in_family(name: Optional[str], family: str) -> bool:
    """Whether a span is ``family`` or one of its children (``ssm.scan``
    in ``ssm``)."""
    return name is not None and name.split(".")[0] == family
