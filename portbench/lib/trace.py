"""Reduce a ``torch.profiler`` trace of part of the window to what the
per-layer readers need, in memory (no trace file is written).

Two traces are read, each of whole prefills between two synchronisations.
The device trace records CUDA activity alone, so the host runs as it does
untraced: its window is its operations' span on the device clock, from the
first one's start to the last one's end (``reduce_device``).  The host
trace records the CPU's operators too, within one ``record_function``
range (``reduce``): each kernel is tied to the host call that launched it
by its correlation id, and ``in_aten`` says whether that launch came from
inside a PyTorch operator (``cpu_op``) or from outside every operator, as
a ``ctypes`` or Triton launch of the port's own kernels does; the host's
events name what it was doing in each of the device's idle gaps.  Device
operations are the profiler's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` activities.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
NO_HOST_OP = "(no host op)"
NAME_CHARS = 160


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: times in ns on the profiler's clock."""
    name: str
    kind: str                # the profiler's activity type
    on_device: bool
    start: int
    end: int
    correlation: int = 0
    thread: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str
    start: int
    end: int
    in_aten: Optional[bool]   # None: no launch found for it


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def kind_of(name: str, on_device: bool) -> str:
    """The activity type from an event's name, for a PyTorch whose events
    do not carry it: device copies and memsets by their names, CUDA API
    calls by theirs, operators by the ``aten::`` namespace."""
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op" if name.startswith("aten::") else "user_annotation"


def events_of(prof) -> List[Event]:
    """The kineto events of a finished ``torch.profiler.profile``.  Device
    events named as a host range are the range's shadow on the device
    (``gpu_user_annotation``), not work, and are left out."""
    raw = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in raw
              if not str(e.device_type()).endswith("CUDA")
              and not e.name().startswith(("aten::", "cuda", "cu"))}
    out = []
    for e in raw:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        start = _ns(e, "start")
        end = int(e.end_ns()) if hasattr(e, "end_ns") \
            else start + _ns(e, "duration")
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type())
        elif on_device and name in ranges:
            kind = "gpu_user_annotation"
        else:
            kind = kind_of(name, on_device)
        out.append(Event(name=name, kind=kind, on_device=on_device,
                         start=start, end=end,
                         correlation=int(e.correlation_id()),
                         thread=int(e.start_thread_id())))
    return out


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _inside(point: int, merged: List[Tuple[int, int]]) -> bool:
    i = bisect.bisect_right(merged, (point, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= point <= merged[i][1]


@dataclasses.dataclass
class Trace:
    t0: int
    t1: int
    prefills: int
    ops: List[DeviceOp]
    host: List[Event]         # the window's thread, sorted by start

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        return _merge((max(o.start, self.t0), min(o.end, self.t1))
                      for o in self.ops)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds(self, keep: Callable[[DeviceOp], bool] = lambda o: True
                ) -> float:
        return sum(o.end - o.start for o in self.ops if keep(o)) / 1e9

    def count(self, keep: Callable[[DeviceOp], bool] = lambda o: True) -> int:
        return sum(1 for o in self.ops if keep(o))

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def idle_by_host(self, n: int = 10) -> List[list]:
        """Idle device time summed by the innermost host event running at
        each gap's midpoint (``NO_HOST_OP`` where none runs: Python)."""
        mids = sorted(((s + e) // 2, e - s) for s, e in self.idle_gaps())
        stack: List[Event] = []
        i, by_name = 0, {}
        for mid, length in mids:
            while i < len(self.host) and self.host[i].start <= mid:
                ev = self.host[i]
                while stack and stack[-1].end < ev.start:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            name = stack[-1].name if stack else NO_HOST_OP
            by_name[name] = by_name.get(name, 0) + length
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]


def reduce(events: Sequence[Event], window: str, prefills: int) -> Trace:
    """The ``Trace`` of the range named ``window``."""
    spans = [e for e in events if e.name == window and not e.on_device]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host ranges named {window!r}")
    span = spans[0]
    t0, t1 = span.start, span.end
    aten = _merge((e.start, e.end) for e in events
                  if e.kind == "cpu_op" and e.thread == span.thread)
    launch_at = {e.correlation: e.start for e in events
                 if e.kind in LAUNCH_KINDS}
    ops = []
    for e in events:
        if not (e.on_device and e.kind in DEVICE_KINDS and t0 <= e.start <= t1):
            continue
        at = launch_at.get(e.correlation)
        ops.append(DeviceOp(e.name, e.kind, e.start, e.end,
                            None if at is None else _inside(at, aten)))
    # CUDA API calls carry the system's thread id, operators the
    # profiler's own: both are the window's thread when one thread launches
    host = sorted((e for e in events if not e.on_device and e is not span
                   and (e.thread == span.thread or e.kind in LAUNCH_KINDS)
                   and t0 <= e.start <= t1),
                  key=lambda e: (e.start, -e.end))
    return Trace(t0, t1, prefills, ops, host)


def reduce_device(events: Sequence[Event], prefills: int) -> Trace:
    """The ``Trace`` of a CUDA-only profile: every device operation, the
    window their span on the device clock."""
    ops = [DeviceOp(e.name, e.kind, e.start, e.end, None) for e in events
           if e.on_device and e.kind in DEVICE_KINDS]
    if not ops:
        return Trace(0, 0, prefills, [], [])
    return Trace(min(o.start for o in ops), max(o.end for o in ops),
                 prefills, ops, [])
