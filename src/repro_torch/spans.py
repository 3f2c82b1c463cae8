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
shared block (``models/transformer.py``): its ``attn`` (and ``attn.flash``)
and ``shared.mlp`` lie inside it, and the concat, both norms and the call's
projection are its own time.  What falls in no child of a span is that
span's own time: the block pre-norms and residual adds are ``prefill``'s.

``counts()`` is every counter of the port's modules already imported, in
one flat dict: the kernels' ``LAUNCHES`` under their own keys, the MoE
FFN's ``ROWS`` as ``moe.routed``, ``moe.computed`` and ``moe.ragged``, and
the shared blocks' ``SHARED`` as ``shared.calls``.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Callable, Dict, Iterator, Optional

import torch

__all__ = ["NAMES", "span", "spanned", "off", "is_recording", "counts"]

NAMES = ("prefill", "embed", "head",
         "attn", "attn.flash",
         "moe", "moe.router", "moe.dispatch", "moe.experts", "moe.combine",
         "ssm", "ssm.conv", "ssm.scan", "ssm.gate_norm",
         "shared", "shared.mlp")
_KNOWN = frozenset(NAMES)
_OFF = contextlib.nullcontext()
_off = False
_outer: Optional[bool] = None    # the outermost open span's decision

# the modules whose counters ``counts`` reads, and the prefix of each key
_COUNTERS = (("repro_torch.kernels.flash_attention", "LAUNCHES", ""),
             ("repro_torch.kernels.ssd_scan", "LAUNCHES", ""),
             ("repro_torch.kernels.gate_norm", "LAUNCHES", ""),
             ("repro_torch.kernels.renewal_scan", "LAUNCHES", ""),
             ("repro_torch.models.moe", "ROWS", "moe."),
             ("repro_torch.models.transformer", "SHARED", "shared."))


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


def counts() -> Dict[str, int]:
    """Every counter of the port's modules already imported (none is
    imported here), as one flat dict of ints."""
    out: Dict[str, int] = {}
    for module, attr, prefix in _COUNTERS:
        found = sys.modules.get(module)
        if found is not None:
            out.update({prefix + k: int(v)
                        for k, v in getattr(found, attr).items()})
    return out
