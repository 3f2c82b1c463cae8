"""Per-operation cost walker, the counterpart of ``repro.launch.hlo_analysis``.

The reference walks the optimized HLO of a compiled step.  The port has no
HLO: it runs the step eagerly under a dispatch mode (``OpTrace``) that
sees every local ATen operation and applies the reference's cost rules
(``analyze_hlo``) to each, one rule per class of operation:

  * flops       — the local products' flops, from
                  ``torch.utils.flop_counter``'s formulas (``mm``,
                  ``bmm``, ``addmm``, ``baddbmm``, convolutions and the
                  attention ops that reach the dispatcher);
  * collectives — per kind, the ring-model wire bytes (``wire_bytes``, the
                  reference's ``_wire_bytes``) of the result of every
                  ``_c10d_functional`` collective, and counts;
                  ``wait_tensor`` is the reference's ``-done`` and counts
                  nothing;
  * bytes       — an HBM-traffic model with fused pointwise chains:
      - products (every op with a flop formula): operand plus result
        bytes, as the reference's ``dot``;
      - collectives: result plus operand bytes;
      - views and aliases (``func.is_view``, in-place view changes such
        as ``squeeze_``, and outputs sharing an input's storage that the
        op does not mutate), and the creation of
        empty or constant storage: nothing (the reference's
        ``_NO_TRAFFIC``);
      - slice reads (``index_select``, ``gather``, ``embedding``,
        ``index``, a ``narrow`` or ``slice`` copied out): twice the
        result, as ``dynamic-slice``;
      - slice writes and scatters (``index_put_``, ``index_add_``,
        ``scatter*``, the slicing backwards, ``copy_`` into part of a
        storage): twice the update, as ``dynamic-update-slice`` and
        ``scatter``;
      - everything else is fusible (pointwise ops, reductions, casts,
        ``cat``, ``clone``): the reference's ``fusion`` rule, which writes
        its result once and counts its reads at their producers.  A chain
        of fusible ops is one fusion: a fusible result is counted only
        when a non-fusible op first reads it, or at the end when it is one
        of the step's outputs.  A result that only fusible ops read, or
        that nothing reads, counts nothing.

Trip counts need no parsing: every layer, microbatch and chunk of the step
is a Python-level repetition that the dispatcher sees, so the reference's
``while`` multiplication is built in.  The model is not XLA's in two ways:
XLA duplicates a cheap producer into each of its consumers and has its own
limits on what fuses (around products, reductions and layout changes), so
its byte count differs from this one by a few percent on a small MLP and
more on a whole step (PERF.md §6 gives the measured ratios).  Only what the
dispatcher sees is counted: a hand-written kernel loaded through ``ctypes``
(``repro_torch.kernels``) is not an ATen operation, so a path that launches
one is undercounted by that kernel's work and traffic.

Each storage is keyed weakly (``WeakIdKeyDictionary``) with a sequence
number given when it is first seen: ``meta`` tensors all have data pointer
0, and ``id`` values are reused once a storage is freed.  The walker holds
no strong reference to any tensor, so on a card it adds nothing to the
step's peak memory.  It counts the local operations of plain tensors on
its device (``meta`` in the dry run, a card or the CPU elsewhere) and
skips DTensor's own dispatch and shape propagation: the local operations
DTensor issues for each rank are what it counts.

Usage:
  out, cost = analyze(step, params, opt_state, batch)
  cost.flops, cost.bytes, cost.collective_bytes, cost.collective_counts
"""
from __future__ import annotations

import dataclasses
import weakref
from array import array
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVES", "OpCost", "OpTrace", "analyze", "wire_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives DTensor issues -> the reference's kinds
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# creation of empty or constant storage: no traffic
_CREATION = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "scalar_tensor", "arange", "linspace",
    "eye", "lift_fresh_copy"})
# slice reads: twice the result
_SLICE_READS = frozenset({
    "index_select", "gather", "embedding", "index", "narrow_copy",
    "slice_copy"})
# slice writes and scatters: twice the update, named here
_SLICE_WRITES = {
    "index_put": "values", "index_put_": "values", "_index_put_impl_": "values",
    "index_add": "source", "index_add_": "source",
    "index_copy": "source", "index_copy_": "source",
    "scatter": "src", "scatter_": "src", "scatter_add": "src",
    "scatter_add_": "src", "scatter_reduce": "src", "scatter_reduce_": "src",
    "slice_scatter": "src", "select_scatter": "src",
    "slice_backward": "grad_output", "select_backward": "grad_output",
    "embedding_dense_backward": "grad_output",
}


def wire_bytes(kind: str, result_bytes: float, k: int) -> float:
    """Per-device wire bytes under a ring schedule with group size k.

    all-gather     result is the gathered tensor: (k-1)/k x result
    reduce-scatter result is the shard: input = k x result, wire (k-1) x result
    all-reduce     RS + AG on the (unsharded) payload: 2 (k-1)/k x result
    all-to-all     (k-1)/k x result
    collective-permute  one hop: result
    """
    if k <= 1:
        return 0.0
    f = (k - 1) / k
    if kind == "all-gather":
        return f * result_bytes
    if kind == "reduce-scatter":
        return (k - 1) * result_bytes
    if kind == "all-reduce":
        return 2.0 * f * result_bytes
    if kind == "all-to-all":
        return f * result_bytes
    return result_bytes


@dataclasses.dataclass
class OpCost:
    """Per-device cost of a step: the fields of the reference's
    ``HloCost``."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in COLLECTIVES:
            self.collective_bytes[k] += other.collective_bytes[k] * mult
            self.collective_counts[k] += other.collective_counts[k] * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(*values) -> list:
    """The tensors among an op's arguments or results: tensors, and
    tensors in lists or tuples (ATen nests no deeper)."""
    out = []
    for x in values:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


def _dtensor_types() -> tuple:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                # a build without torch.distributed
        return ()
    return (DTensor,)


def _locals(tree) -> list:
    """The plain tensors of a tree, DTensors by their local shards."""
    kinds = _dtensor_types()
    return [t.to_local() if kinds and isinstance(t, kinds) else t
            for t in _tensors(tree)]


class OpTrace(TorchDispatchMode):
    """A dispatch mode that counts the local operations of one step on
    ``device`` (see the module docstring).  Around the step::

        trace = OpTrace("meta")
        trace.arguments(args)          # the step's inputs, before it runs
        with trace:
            out = step(*args)
        trace.outputs(out)             # count the fused results it returns

    then ``trace.cost`` (an ``OpCost``), ``trace.peak_bytes`` and
    ``trace.temp_bytes``.

    ``peak_bytes`` is the most bytes alive at once during the step,
    arguments included: each storage that an argument or a counted op's
    output holds, from when it is first seen until it is freed.
    ``temp_bytes`` is the most bytes alive at once that belong to neither
    the arguments nor the outputs.  Both are exact for the order in which
    the ops ran (a storage lives until Python drops its last reference);
    neither is a bound on what a compiler that reorders the ops could
    reach, and neither counts the allocator's rounding or cache.
    """

    def __init__(self, device="meta"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.device = torch.device(device).type
        self.cost = OpCost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.temp_bytes = 0
        self._flop_registry = flop_registry
        self._skip = _dtensor_types()
        self._seq = WeakIdKeyDictionary()     # storage -> sequence number
        self._next_seq = 0
        self._size: Dict[int, int] = {}       # live storages' bytes
        self._pending: Dict[int, int] = {}    # fused results not yet counted
        self._args: Dict[int, int] = {}       # the arguments' storages
        self._alloc_seq = array("q")          # first sight of each storage,
        self._alloc_live = array("q")         # and live bytes just after

    # -- storages --------------------------------------------------------

    def _key(self, t: torch.Tensor) -> int:
        """The sequence number of ``t``'s storage, tracked from here on."""
        st = t.untyped_storage()
        seq = self._seq.get(st)
        if seq is not None:
            return seq
        seq = self._next_seq
        self._next_seq += 1
        self._seq[st] = seq
        n = st.nbytes()
        self._size[seq] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._alloc_seq.append(seq)
        self._alloc_live.append(self.live_bytes)
        weakref.finalize(st, self._free, seq, n)
        return seq

    def _free(self, seq: int, n: int) -> None:
        self.live_bytes -= n
        self._size.pop(seq, None)
        self._pending.pop(seq, None)

    def _read(self, seqs) -> None:
        """A non-fusible op reads these storages: the fused results among
        them are written now."""
        for seq in seqs:
            self.cost.bytes += self._pending.pop(seq, 0)

    def _written(self, seqs) -> None:
        for seq in seqs:
            self._pending.pop(seq, None)

    def _fused(self, tensors, seqs) -> None:
        for t, seq in zip(tensors, seqs):
            self._pending[seq] = min(self._pending.get(seq, 0) + _nbytes((t,)),
                                     self._size[seq])

    # -- around the step -------------------------------------------------

    def arguments(self, tree) -> None:
        """Track the step's inputs (their storages count in ``peak_bytes``
        and never in ``temp_bytes``)."""
        for t in _locals(tree):
            seq = self._key(t)
            self._args[seq] = self._size[seq]

    def outputs(self, tree) -> None:
        """Count the fused results that the step returns, and set
        ``temp_bytes``."""
        outs = {}
        for t in _locals(tree):
            st = t.untyped_storage()
            seq = self._seq.get(st)
            if seq is None:
                continue
            self.cost.bytes += self._pending.pop(seq, 0)
            if seq not in self._args:
                outs[seq] = self._size[seq]
        args = sum(self._args.values())
        out_live = 0
        temp = 0
        for seq, live in zip(self._alloc_seq, self._alloc_live):
            if seq in self._args:
                continue
            out_live += outs.get(seq, 0)
            temp = max(temp, live - args - out_live)
        self.temp_bytes = temp

    # -- the dispatch ----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._skip and any(issubclass(t, self._skip) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _op_tensors(*out) if isinstance(out, (list, tuple)) \
            else _op_tensors(out)
        if (outs and all(type(t) is torch.Tensor for t in outs)
                and any(t.device.type == self.device for t in outs)):
            self._count(func, args, kwargs, out, outs)
        return out

    def _count(self, func, args, kwargs, out, outs) -> None:
        cost = self.cost
        packet = func._overloadpacket
        name = packet.__name__
        out_seqs = [self._key(t) for t in outs]
        if (func.is_view or torch.Tag.inplace_view in func.tags
                or name in _CREATION):
            return
        ins = [t for t in _op_tensors(*args, *kwargs.values())
               if type(t) is torch.Tensor]
        # outputs were tracked first, so an aliased input has a number
        in_seqs = [seq for seq in map(self._seq.get,
                                      (t.untyped_storage() for t in ins))
                   if seq is not None]
        if packet in self._flop_registry:
            cost.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
            cost.bytes += _nbytes(ins) + _nbytes(outs)
        elif func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                b = _nbytes(outs)
                cost.collective_bytes[kind] += wire_bytes(kind, b,
                                                          _group_size(args))
                cost.collective_counts[kind] += 1
                cost.bytes += b + _nbytes(ins)
            else:
                in_seqs = ()                     # wait_tensor reads nothing
        elif not func._schema.is_mutable and not set(out_seqs).isdisjoint(
                in_seqs):
            return                                      # an alias
        elif name in _SLICE_READS:
            cost.bytes += 2 * _nbytes(outs)
        else:
            update = _update_bytes(func, name, args, kwargs, outs)
            if update is None:
                self._fused(outs, out_seqs)
                return
            cost.bytes += 2 * update
        self._read(in_seqs)
        self._written(out_seqs)


def _arg(func, args, kwargs, name: str):
    """Argument ``name`` of a call of ``func``, or None."""
    if name in kwargs:
        return kwargs[name]
    names = [a.name for a in func._schema.arguments]
    i = names.index(name) if name in names else len(args)
    return args[i] if i < len(args) else None


def _update_bytes(func, name: str, args, kwargs, outs) -> Optional[int]:
    """The update's bytes of a slice write or scatter; None for any other
    op (``copy_`` is one only into part of a storage)."""
    if name == "copy_":
        dst = args[0]
        view = _nbytes((dst,))
        return view if view < dst.untyped_storage().nbytes() else None
    if name not in _SLICE_WRITES:
        return None
    value = _arg(func, args, kwargs, _SLICE_WRITES[name])
    if isinstance(value, torch.Tensor):
        return _nbytes((value,))
    index = _arg(func, args, kwargs, "index")          # a scalar update
    return index.numel() * outs[0].element_size()


def _device_of(tree) -> str:
    ts = _locals(tree)
    return ts[0].device.type if ts else "cpu"


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an ``OpTrace`` on the device of its
    first tensor argument; return its output and the ``OpCost``."""
    trace = OpTrace(_device_of((args, kwargs)))
    trace.arguments((args, kwargs))
    with trace:
        out = fn(*args, **kwargs)
    trace.outputs(out)
    return out, trace.cost
