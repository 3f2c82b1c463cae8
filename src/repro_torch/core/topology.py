"""Correlated failures over a node topology: shared shocks + trace ingestion.

Counterpart of ``repro.core.topology``.  Every process in ``core.failures``
samples independent per-node gaps; real clusters fail in spatially
correlated bursts (a PSU trip fells a rack, a cooling event ages every node
under it).  This module adds that axis as a marked point process over a
node tree:

  * ``Topology`` — a static node -> group map per level (rack, PSU, ...),
    each level with per-group exponential shock clocks (mean
    ``shock_mtbs_s``), a per-member kill probability ``p_kill`` and an
    ``age_boost_s`` added to the failure clocks of the members a shock
    spares.
  * ``sample_correlated_renewal_gaps`` — the competing-risks recursion of
    ``failures.sample_renewal_gaps`` with the group shock clocks racing the
    individual residuals, on the device: ``(gaps, failed_mask, primary)``,
    where ``failed_mask`` marks every node felled in the epoch and
    ``primary`` is the node whose lost work anchors the epoch's
    re-execution.  Every renewal engine samples through it, so for a key
    every engine sees the same correlated histories.
  * LANL-style trace ingestion (host numpy, the reference's code):
    ``parse_lanl_csv``/``to_lanl_csv``, ``history_to_log``,
    ``find_bursts``, ``burst_replay_gaps`` (whole bursts resampled),
    ``trace_to_empirical``, ``fit_shock_rates`` and ``dispersion_index``.

Shock semantics (the reference's, exact under the quiesce policy): all
clocks freeze during a recovery epoch, shock clocks are exponential and so
redrawn at every anchor, and the epoch event is the minimum over every
individual residual and every group shock clock.  An individual event
(which wins ties) fells the argmin node; a shock at group ``g`` kills each
member with probability ``p_kill``, and if none is killed the member with
the smallest kill draw falls anyway (every epoch ends in a failure).
Spared members get ``age_boost_s``; felled clocks reset.

The uniforms are ``jax.random``'s bit for bit (``core.prng``), in the
reference's stream order: ``split(key, 3)`` gives the residual, shock and
kill streams.  The shock clocks' ``log1p`` and the process's special
functions are the backend's own, so a history can differ from the
reference's (or from another device's) by an ulp in a gap.
"""
from __future__ import annotations

import dataclasses
import io
import pathlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import failures
from repro_torch.core import planning
from repro_torch.core import prng

__all__ = [
    "TopologyLevel",
    "Topology",
    "rack_topology",
    "sample_correlated_renewal_gaps",
    "correlated_renewal_gaps",
    "survivor_slot_mask",
    "FailureTraceLog",
    "parse_lanl_csv",
    "to_lanl_csv",
    "history_to_log",
    "find_bursts",
    "trace_to_empirical",
    "burst_replay_gaps",
    "fit_shock_rates",
    "dispersion_index",
]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the topology tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologyLevel:
    """One level of shared-shock structure (e.g. "rack").

    ``group_of`` maps node index -> group index at this level.
    ``shock_mtbs_s`` is the mean time between shocks per group (scalar or
    per-group array); ``p_kill`` the per-member kill probability when the
    group's shock fires; ``age_boost_s`` the failure-clock advance of the
    members the shock spares.
    """

    name: str
    group_of: tuple
    shock_mtbs_s: Any
    p_kill: Any = 1.0
    age_boost_s: Any = 0.0

    def __post_init__(self):
        groups = tuple(int(g) for g in self.group_of)
        if not groups:
            raise ValueError(f"level {self.name!r}: empty group_of")
        n_groups = max(groups) + 1
        if min(groups) < 0 or set(groups) != set(range(n_groups)):
            raise ValueError(
                f"level {self.name!r}: group ids must cover 0..G-1, "
                f"got {sorted(set(groups))}")
        object.__setattr__(self, "group_of", groups)
        object.__setattr__(self, "shock_mtbs_s",
                           failures._param(self.shock_mtbs_s))
        object.__setattr__(self, "p_kill", failures._param(self.p_kill))
        object.__setattr__(self, "age_boost_s",
                           failures._param(self.age_boost_s))
        failures._check_positive("shock_mtbs_s", self.shock_mtbs_s)
        pk = np.asarray(self.p_kill, np.float64)
        if np.any(pk <= 0.0) or np.any(pk > 1.0):
            raise ValueError(f"p_kill must be in (0, 1], got {pk}")
        boost = np.asarray(self.age_boost_s, np.float64)
        if np.any(boost < 0.0):
            raise ValueError(f"age_boost_s must be >= 0, got {boost}")

    @property
    def n_groups(self) -> int:
        return max(self.group_of) + 1


@dataclasses.dataclass(frozen=True)
class Topology:
    """A stack of shock levels over ``n_nodes`` physical nodes."""

    n_nodes: int
    levels: tuple

    def __post_init__(self):
        levels = tuple(self.levels)
        if not levels:
            raise ValueError("topology needs at least one level")
        for lv in levels:
            if not isinstance(lv, TopologyLevel):
                raise TypeError(f"not a TopologyLevel: {lv!r}")
            if len(lv.group_of) != self.n_nodes:
                raise ValueError(
                    f"level {lv.name!r} maps {len(lv.group_of)} nodes, "
                    f"topology has {self.n_nodes}")
        object.__setattr__(self, "levels", levels)

    def label(self) -> str:
        parts = ",".join(f"{lv.name}x{lv.n_groups}" for lv in self.levels)
        return f"topology(n={self.n_nodes};{parts})"


def rack_topology(n_nodes: int, rack_size: int, *, shock_mtbs_s,
                  p_kill=1.0, age_boost_s=0.0) -> Topology:
    """The common case: consecutive nodes grouped into racks of
    ``rack_size`` (the last rack may be short), one shock level."""
    if rack_size < 1:
        raise ValueError("rack_size must be >= 1")
    group_of = tuple(i // rack_size for i in range(n_nodes))
    return Topology(n_nodes=n_nodes, levels=(
        TopologyLevel(name="rack", group_of=group_of,
                      shock_mtbs_s=shock_mtbs_s, p_kill=p_kill,
                      age_boost_s=age_boost_s),))


def _member_matrix(topo: Topology) -> np.ndarray:
    """Static (G_total, n_nodes) bool membership over all levels' groups,
    levels concatenated in order."""
    rows = []
    for lv in topo.levels:
        g = np.asarray(lv.group_of)
        rows.append(np.arange(lv.n_groups)[:, None] == g[None, :])
    return np.concatenate(rows, axis=0)


def _group_params(topo: Topology):
    """Concatenated per-total-group (mtbs, p_kill, age_boost) float32
    arrays."""
    cols = ([], [], [])
    for lv in topo.levels:
        for col, leaf in zip(cols, (lv.shock_mtbs_s, lv.p_kill,
                                    lv.age_boost_s)):
            col.append(np.broadcast_to(np.asarray(leaf, np.float32),
                                       (lv.n_groups,)))
    return tuple(np.concatenate(c) for c in cols)


# ---------------------------------------------------------------------------
# the correlated renewal-epoch sampler
# ---------------------------------------------------------------------------

def sample_correlated_renewal_gaps(topology: Topology,
                                   process: failures.FailureProcess, key,
                                   n_runs: int, max_failures: int,
                                   n_nodes: int, device="cuda"):
    """Correlated renewal-epoch histories on ``device``: ``(gaps,
    failed_mask, primary)`` of shapes ``(R, K)`` float32, ``(R, K, N)`` bool
    and ``(R, K)`` int32.

    A Python loop over the K epochs, vectorised over runs; the event
    semantics are the module docstring's, the reference's line for line.
    """
    if topology.n_nodes != n_nodes:
        raise ValueError(f"topology has {topology.n_nodes} nodes, "
                         f"sampler asked for {n_nodes}")
    dev = resolve_device(device)
    member = torch.as_tensor(_member_matrix(topology), device=dev)  # (G, N)
    mtbs, pkill, boost = (torch.as_tensor(a, device=dev)
                          for a in _group_params(topology))       # (G,)
    n_groups = member.shape[0]
    k_res, k_shock, k_kill = prng.split(key, 3)
    v = prng.uniform(k_res, (max_failures, n_runs, n_nodes), dev)
    w = prng.uniform(k_kill, (max_failures, n_runs, n_nodes), dev)
    su = prng.uniform(k_shock, (max_failures, n_runs, n_groups), dev)
    node_ids = torch.arange(n_nodes, device=dev)
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=dev)

    ages = torch.zeros((n_runs, n_nodes), dtype=torch.float32, device=dev)
    gaps, masks, primaries = [], [], []
    for k in range(max_failures):
        v_k, w_k = v[k], w[k]
        t = process.residual(v_k, ages)                        # (R, N)
        gap_ind = torch.amin(t, dim=-1)
        i_ind = torch.argmin(t, dim=-1)
        # fresh exponential shock clocks per anchor (exact: memoryless)
        s_times = mtbs * (-torch.log1p(-su[k]))                # (R, G)
        gap_shk = torch.amin(s_times, dim=-1)
        g_shk = torch.argmin(s_times, dim=-1)
        shock = gap_shk < gap_ind                              # ties -> individual
        gap = torch.where(shock, gap_shk, gap_ind)
        member_g = member[g_shk]                               # (R, N)
        killed = member_g & (w_k < pkill[g_shk][:, None])
        # condition on >= 1 kill: the member with the smallest kill draw
        # falls even when every Bernoulli spares
        w_m = torch.where(member_g, w_k, inf)
        forced = node_ids == torch.argmin(w_m, dim=-1)[:, None]
        killed = torch.where(killed.any(dim=-1, keepdim=True), killed, forced)
        mask = torch.where(shock[:, None], killed, node_ids == i_ind[:, None])
        primary = torch.where(
            shock, torch.argmin(torch.where(killed, w_k, inf), dim=-1),
            i_ind).to(torch.int32)
        spared = shock[:, None] & member_g & ~killed
        ages = torch.where(
            mask, 0.0,
            ages + gap[:, None]
            + torch.where(spared, boost[g_shk][:, None], 0.0))
        gaps.append(gap)
        masks.append(mask)
        primaries.append(primary)
    return (torch.stack(gaps, dim=1), torch.stack(masks, dim=1),
            torch.stack(primaries, dim=1))


def correlated_renewal_gaps(topology: Topology,
                            process: failures.FailureProcess, key,
                            n_runs: int, n_nodes: int, max_failures: int,
                            device="cuda"):
    """Host entry point: numpy ``(gaps float64, failed_mask bool, primary
    int64)`` from the sampler the engines run (on ``device``) — the float64
    cast of the float32 gaps, so every engine sees the same histories."""
    gaps, mask, primary = sample_correlated_renewal_gaps(
        topology, process, key, n_runs, max_failures, n_nodes, device)
    return (_np(gaps).astype(np.float64), _np(mask).astype(bool),
            _np(primary).astype(np.int64))


def survivor_slot_mask(failed_mask, primary):
    """Map a physical-node felled mask to survivor-slot space: slot ``i``
    is physical node ``i + (i >= primary)`` (the nodes in order, skipping
    the primary).  numpy in, numpy out; torch in, torch out (on the mask's
    device).  Shapes ``(..., N) -> (..., N - 1)`` with ``primary``
    shaped ``(...)``."""
    n = failed_mask.shape[-1]
    if planning._ns(failed_mask, primary) is torch:
        failed_mask = torch.as_tensor(failed_mask)
        primary = torch.as_tensor(primary, device=failed_mask.device)
        idx = torch.arange(n - 1, device=failed_mask.device)
        phys = idx + (idx >= primary[..., None]).to(idx.dtype)
        return torch.gather(
            failed_mask, -1, phys.expand(failed_mask.shape[:-1] + (n - 1,)))
    idx = np.arange(n - 1)
    phys = idx + (idx >= np.asarray(primary)[..., None])
    return np.take_along_axis(np.asarray(failed_mask), phys, axis=-1)


# ---------------------------------------------------------------------------
# LANL-style trace ingestion (host numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FailureTraceLog:
    """A parsed failure trace: one row per node failure, time-sorted."""

    node: np.ndarray          # (E,) int64 node ids in [0, n_nodes)
    t_s: np.ndarray           # (E,) float64 failure timestamps, ascending
    downtime_s: np.ndarray    # (E,) float64 repair durations
    n_nodes: int

    def __post_init__(self):
        node = np.asarray(self.node, np.int64).ravel()
        t = np.asarray(self.t_s, np.float64).ravel()
        down = np.asarray(self.downtime_s, np.float64).ravel()
        if not (node.size == t.size == down.size):
            raise ValueError("node/t_s/downtime_s must be equal length")
        if node.size == 0:
            raise ValueError("empty failure trace")
        order = np.argsort(t, kind="stable")
        node, t, down = node[order], t[order], down[order]
        n_nodes = int(self.n_nodes) if self.n_nodes else int(node.max()) + 1
        if node.min() < 0 or node.max() >= n_nodes:
            raise ValueError(f"node ids outside [0, {n_nodes})")
        object.__setattr__(self, "node", node)
        object.__setattr__(self, "t_s", t)
        object.__setattr__(self, "downtime_s", down)
        object.__setattr__(self, "n_nodes", n_nodes)

    def __len__(self) -> int:
        return int(self.node.size)

    @property
    def span_s(self) -> float:
        return float(self.t_s[-1] - self.t_s[0])


def parse_lanl_csv(source, *, n_nodes: Optional[int] = None) -> FailureTraceLog:
    """Parse a LANL-style failure trace CSV: ``node,timestamp,downtime``
    rows (a header line is skipped when the first field is non-numeric).
    ``source`` is a path, a string of CSV text, or an iterable of lines;
    ``n_nodes`` overrides the inferred count (``max id + 1``)."""
    if isinstance(source, (str, pathlib.Path)) and "\n" not in str(source):
        lines = pathlib.Path(source).read_text().splitlines()
    elif isinstance(source, str):
        lines = source.splitlines()
    else:
        lines = [str(l) for l in source]
    node, t, down = [], [], []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 3:
            raise ValueError(f"line {i + 1}: expected node,timestamp,"
                             f"downtime — got {line!r}")
        try:
            n_id = int(float(parts[0]))
        except ValueError:
            if not node:                 # header row
                continue
            raise ValueError(f"line {i + 1}: bad node id {parts[0]!r}")
        node.append(n_id)
        t.append(float(parts[1]))
        down.append(float(parts[2]))
    return FailureTraceLog(node=np.asarray(node), t_s=np.asarray(t),
                           downtime_s=np.asarray(down),
                           n_nodes=n_nodes or 0)


def to_lanl_csv(log: FailureTraceLog) -> str:
    """Serialize a trace back to the ``node,timestamp,downtime`` format."""
    buf = io.StringIO()
    buf.write("node,timestamp,downtime\n")
    for n, t, d in zip(log.node, log.t_s, log.downtime_s):
        buf.write(f"{int(n)},{t:.6f},{d:.6f}\n")
    return buf.getvalue()


def history_to_log(gaps, failed_mask, *, downtime_s: float = 600.0,
                   run: int = 0) -> FailureTraceLog:
    """Flatten one sampled renewal history (``correlated_renewal_gaps``
    output) into an absolute-timestamp trace: epoch anchors are the
    cumulative balanced gaps, and every felled node of an epoch fails at
    that anchor."""
    gaps = np.atleast_2d(_np(gaps).astype(np.float64))[run]
    mask = _np(failed_mask).astype(bool)
    mask = mask[run] if mask.ndim == 3 else mask
    t_abs = np.cumsum(gaps)
    node, t = [], []
    for k in range(gaps.shape[0]):
        for i in np.nonzero(mask[k])[0]:
            node.append(int(i))
            t.append(float(t_abs[k]))
    return FailureTraceLog(
        node=np.asarray(node), t_s=np.asarray(t),
        downtime_s=np.full(len(node), float(downtime_s)),
        n_nodes=mask.shape[-1])


def find_bursts(log: FailureTraceLog, burst_window_s: float) -> list:
    """Group trace events into bursts: an event within ``burst_window_s``
    of the previous event joins its burst.  Returns a list of
    ``(t0, node_tuple)`` with nodes in event order (repeats kept)."""
    bursts = []
    cur_nodes, cur_t0, last_t = [], None, None
    for n, t in zip(log.node, log.t_s):
        if last_t is None or t - last_t > burst_window_s:
            if cur_nodes:
                bursts.append((cur_t0, tuple(cur_nodes)))
            cur_nodes, cur_t0 = [], float(t)
        cur_nodes.append(int(n))
        last_t = t
    if cur_nodes:
        bursts.append((cur_t0, tuple(cur_nodes)))
    return bursts


def trace_to_empirical(log: FailureTraceLog) -> failures.EmpiricalTrace:
    """The marginal view of a trace: per-node inter-failure gaps pooled
    into one ``EmpiricalTrace`` (node correlation is dropped — that is what
    ``burst_replay_gaps`` keeps)."""
    pooled = []
    for n in range(log.n_nodes):
        t_n = log.t_s[log.node == n]
        if t_n.size >= 2:
            pooled.extend(np.diff(t_n).tolist())
    pooled = np.asarray([g for g in pooled if g > 0.0], np.float64)
    if pooled.size < 2:
        raise ValueError("trace has fewer than 2 positive per-node gaps")
    return failures.EmpiricalTrace(pooled)


def burst_replay_gaps(log: FailureTraceLog, key, n_runs: int,
                      max_failures: int, *, burst_window_s: float,
                      n_nodes: Optional[int] = None):
    """Correlation-preserving replay: resample whole bursts, never
    individual gaps.  Each replayed epoch draws one (inter-burst start gap,
    felled node set) pair uniformly with replacement.  Returns ``(gaps
    (R, K) float64, failed_mask (R, K, N) bool, primary (R, K) int64)``,
    the triple ``correlated_renewal_gaps`` gives.  Deterministic for a key:
    numpy's generator is seeded with the key's two words, as the
    reference seeds it, so replays are the reference's bit for bit."""
    n = int(n_nodes or log.n_nodes)
    bursts = find_bursts(log, burst_window_s)
    if len(bursts) < 2:
        raise ValueError("need >= 2 bursts to resample inter-burst gaps")
    starts = np.asarray([t0 for t0, _ in bursts], np.float64)
    inter = np.diff(starts)                      # start-to-start gaps
    inter = inter[inter > 0.0]
    if inter.size == 0:
        raise ValueError("all inter-burst gaps are zero")
    node_sets = [tuple(sorted(set(ns))) for _, ns in bursts]
    rng = np.random.default_rng(np.asarray(key, np.uint32).ravel())
    gap_idx = rng.integers(0, inter.size, size=(n_runs, max_failures))
    set_idx = rng.integers(0, len(node_sets), size=(n_runs, max_failures))
    gaps = inter[gap_idx]
    mask = np.zeros((n_runs, max_failures, n), bool)
    primary = np.zeros((n_runs, max_failures), np.int64)
    for r in range(n_runs):
        for k in range(max_failures):
            ns = node_sets[set_idx[r, k]]
            mask[r, k, list(ns)] = True
            primary[r, k] = ns[0]
    return gaps, mask, primary


def fit_shock_rates(log: FailureTraceLog, topology: Topology, *,
                    burst_window_s: float) -> dict:
    """Estimate per-level shock MTBS from inter-failure clustering.

    Bursts (>= 2 distinct nodes within ``burst_window_s``) are attributed
    to the finest level whose single group holds every burst node;
    singleton bursts count as individual failures.  A level with ``G``
    groups over span ``T`` with ``B`` bursts has MTBS ``G * T / B``.
    Returns ``{level_name: {"shock_mtbs_s", "n_bursts"}, ...,
    "individual": {"mtbf_s", "n_events"}, "unattributed": count}``.
    """
    bursts = find_bursts(log, burst_window_s)
    span = max(log.span_s, 1e-9)
    # finest level first: most groups = most specific attribution
    order = sorted(range(len(topology.levels)),
                   key=lambda i: -topology.levels[i].n_groups)
    counts = {lv.name: 0 for lv in topology.levels}
    n_single = 0
    n_unattributed = 0
    for _, nodes in bursts:
        uniq = sorted(set(nodes))
        if len(uniq) < 2:
            n_single += 1
            continue
        for i in order:
            lv = topology.levels[i]
            if len({lv.group_of[n] for n in uniq}) == 1:
                counts[lv.name] += 1
                break
        else:
            n_unattributed += 1
    out = {}
    for lv in topology.levels:
        b = counts[lv.name]
        out[lv.name] = {
            "n_bursts": b,
            "shock_mtbs_s": (lv.n_groups * span / b) if b else np.inf,
        }
    out["individual"] = {
        "n_events": n_single,
        "mtbf_s": (log.n_nodes * span / n_single) if n_single else np.inf,
    }
    out["unattributed"] = n_unattributed
    return out


def dispersion_index(event_times, *, span_s: Optional[float] = None,
                     n_windows: int = 64) -> float:
    """Index of dispersion (variance/mean of counts per equal window) of a
    point process: ~1 for Poisson, > 1 for clustered (bursty) arrivals."""
    t = np.sort(np.asarray(event_times, np.float64).ravel())
    if t.size < 2:
        raise ValueError("need >= 2 events")
    t0 = t[0]
    span = float(span_s) if span_s else float(t[-1] - t0)
    if span <= 0.0:
        raise ValueError("zero time span")
    w = np.minimum((((t - t0) / span) * n_windows).astype(np.int64),
                   n_windows - 1)
    counts = np.bincount(w, minlength=n_windows).astype(np.float64)
    mean = counts.mean()
    return float(counts.var() / mean) if mean > 0 else 0.0
