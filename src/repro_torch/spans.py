"""Named ranges inside the prefill path and one place to read the port's
counters.

``span(name)`` marks a part of the forward as a ``torch.profiler``
``record_function`` range, so that a profile of the program puts each
CUDA operation down to the part of the model that launched it: the range
and the launch are host events on one clock, and the profiler ties the
launch to its device operation by correlation id.  A span records only
while a ``torch.profiler.profile`` that collects the CPU's activity runs
and is bound in a caller's frame (``with profile(...) as prof:`` around
the step): a profile of CUDA activity alone, or one no caller holds,
enters no range, and so sees the device operations of an unmarked
program.  ``off()`` keeps spans off under any profiler.  The outermost
span open decides once for the spans inside it.  Otherwise ``span``
returns one shared no-op context: it creates no ``RecordFunction`` and
dispatches no operator, so an unprofiled run, a ``TorchDispatchMode`` and
a mesh step see the operations they saw before spans existed.

The names are fixed (``NAMES``); a dotted name lies inside the span its
prefix names (``ssm.scan`` inside ``ssm``), and ``embed``, ``attn``,
``moe``, ``ssm``, ``shared`` and ``head`` lie inside ``prefill`` when the
prefill step runs them.  ``shared`` is one call of a published Zamba2
shared block: its ``attn`` (and ``attn.flash``) and ``shared.mlp`` lie
inside it, and the concat, both norms and the call's projection are its
own time.  ``attn.qk_norm`` (a model with ``qk_norm``: the RMSNorms of the
whole q and k projections) lies inside ``attn`` in the prefill and stands
alone in a decode step; so does ``moe.shared_expert`` (a shared expert's
SwiGLU over every token) inside ``moe``.  What falls in no child of a span is that span's
own time: the block pre-norms and residual adds are ``prefill``'s.

The port's counters live here too.  A module declares each where it
counts, at import: ``counter("flash_attention")`` is one count under its
own name (each kernel's launches), ``counter("moe", "routed", ...)`` one
count per field, read as ``moe.routed``.  ``counts()`` is every counter
declared so far, in one flat dict, and ``reset_counts()`` zeroes them.
This module imports none of the modules that count.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Callable, Dict, Iterator, Optional

import torch

__all__ = ["NAMES", "span", "spanned", "off", "is_recording", "counter",
           "counts", "reset_counts"]

NAMES = ("prefill", "embed", "head",
         "attn", "attn.flash", "attn.qk_norm",
         "moe", "moe.router", "moe.dispatch", "moe.experts", "moe.combine",
         "moe.shared_expert",
         "ssm", "ssm.conv", "ssm.scan", "ssm.gate_norm",
         "shared", "shared.mlp")
_KNOWN = frozenset(NAMES)
_OFF = contextlib.nullcontext()
_off = False
_outer: Optional[bool] = None    # the outermost open span's decision
# every counter declared, by name: its fields and their counts
_DECLARED: Dict[str, Dict[str, int]] = {}


def _profile_collects_cpu() -> bool:
    """Whether the nearest running ``torch.profiler.profile`` bound in a
    caller's frame collects the CPU's activity (False where none is)."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if (isinstance(value, torch.profiler.profile)
                    and value.profiler is not None
                    and value.profiler.kineto_results is None):
                return torch.profiler.ProfilerActivity.CPU in value.activities
        frame = frame.f_back
    return False


def is_recording() -> bool:
    """Whether a span entered now records a range."""
    return (not _off and torch.autograd._profiler_enabled()
            and _profile_collects_cpu())


class _Outermost:
    """The outermost open span: decides whether it and the spans inside it
    record, so that the profile is looked for once."""

    def __init__(self, name: str):
        self.name, self.range = name, None

    def __enter__(self):
        global _outer
        _outer = is_recording()
        if _outer:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()

    def __exit__(self, *exc):
        global _outer
        _outer = None
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name: str):
    """The context of the span ``name``: a ``record_function`` range while
    spans record, else a shared no-op context."""
    if name not in _KNOWN:
        raise ValueError(f"unknown span {name!r}; spans.NAMES lists them")
    if not torch.autograd._profiler_enabled():
        return _OFF
    if _outer is None:
        return _Outermost(name)
    return torch.profiler.record_function(name) if _outer else _OFF


def spanned(name: str) -> Callable:
    """Decorator: every call of the function runs inside ``span(name)``,
    decided at the call."""
    if name not in _KNOWN:
        raise ValueError(f"unknown span {name!r}; spans.NAMES lists them")

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner

    return wrap


@contextlib.contextmanager
def off() -> Iterator[None]:
    """Spans stay off inside, whatever profiler runs: for a profile that
    has to show exactly the operations of an unmarked program."""
    global _off
    before, _off = _off, True
    try:
        yield
    finally:
        _off = before


def counter(name: str, *fields: str) -> Dict[str, int]:
    """The counter ``name``, declared on its first call: a dict of its
    ``fields`` (``name`` alone if none) at zero, which the declaring module
    adds to in place.  A later call returns the same dict."""
    if name not in _DECLARED:
        _DECLARED[name] = dict.fromkeys(fields or (name,), 0)
    return _DECLARED[name]


def counts() -> Dict[str, int]:
    """Every counter declared so far, as one flat dict of ints: a field
    under ``name.field``, a counter without fields under ``name``."""
    return {(key if key == name else f"{name}.{key}"): int(value)
            for name, fields in _DECLARED.items()
            for key, value in fields.items()}


def reset_counts(*names: str) -> None:
    """Zero the counters ``names``, every declared one by default."""
    for name in names or tuple(_DECLARED):
        fields = _DECLARED[name]
        fields.update(dict.fromkeys(fields, 0))
