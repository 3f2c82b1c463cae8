"""Declarative experiment matrices for the campaign engine (counterpart of
``repro.campaign.spec``).

A campaign is a named matrix of *cells*; each cell is one fully resolved
experiment configuration — a scenario, an optional policy override, a
failure process, and the Monte-Carlo run parameters — expressed as a plain
JSON-able dict.  The matrix is built compositionally from named axes:

    from repro_torch.campaign import spec

    m = (spec.axis("scenario", {n: {"scenario": {"base": n}}
                                for n in ("scenario2_long_reexec",
                                          "scenario4_short_active_waits")})
         * spec.axis("process", {
               "exp": {"process": {"kind": "exponential", "mtbf_s": 6e5}},
               "wb07": {"process": {"kind": "weibull", "k": 0.7,
                                    "mtbf_s": 6e5}}}))
    c = spec.campaign("demo", m, base={
        "run": {"n_runs": 64, "max_failures": 16, "makespan_s": 2.6e6},
        "seed": 0})

``axis`` maps a label to a config *fragment*; ``*`` is the cartesian
product (fragments deep-merged, overlapping scalar keys rejected),
``.zip()`` pairs equal-length axes, ``.filter()`` prunes cells.
``campaign()`` merges each fragment over ``base``, validates, and
normalizes every cell — the normalized dict is what the content hash
(``store.cell_key``) and the runner both consume, so two spellings of the
same experiment collide onto the same stored result.

The cell schema (all keys JSON scalars / nested dicts):

    scenario  {"base": <registry name>, **builder params}
    policy    optional subset of scenarios.apply_policy knobs
    process   {"kind": exponential|weibull|lognormal|gamma, **params}
    topology  optional {"kind": "rack", "rack_size", "shock_mtbs_s",
              "p_kill", "age_boost_s"} — correlated shock sampling over
              the scenario's nodes (core.topology.rack_topology)
    run       n_runs, max_failures, and exactly one of makespan_s | work_s
    seed      int -> prng.PRNGKey(seed) at dispatch (jax.random.PRNGKey's
              key, so a cell draws the reference's uniforms)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core import failures
from repro_torch.core.scenarios import (
    apply_policy, paper_scenarios, sparse_rendezvous_scenario,
)
from repro_torch.core.simulator import ScenarioConfig

# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------

# name -> builder(**params) -> ScenarioConfig.  Scenario specs reference
# builders by name so a cell config stays a pure-data description; new
# scenario families (correlated failures, trace replays, ...) plug in via
# register_scenario without touching the campaign machinery.
_SCENARIO_BUILDERS: dict = {}
_builtins_done = False


def register_scenario(name: str, builder: Callable[..., ScenarioConfig]) -> None:
    """Register a scenario builder under ``name`` for use in cell specs."""
    # builtins first: a custom registration must never pre-populate the dict
    # and suppress them (the dict-non-empty check used to do exactly that)
    _ensure_builtin_scenarios()
    _SCENARIO_BUILDERS[name] = builder


def scenario_names() -> tuple:
    _ensure_builtin_scenarios()
    return tuple(sorted(_SCENARIO_BUILDERS))


def _ensure_builtin_scenarios() -> None:
    global _builtins_done
    if _builtins_done:
        return
    _builtins_done = True
    for name in paper_scenarios():
        _SCENARIO_BUILDERS[name] = (lambda _n=name: paper_scenarios()[_n])
    _SCENARIO_BUILDERS["sparse_rendezvous"] = sparse_rendezvous_scenario


def build_scenario(scenario_spec: Mapping) -> ScenarioConfig:
    """Resolve a ``{"base": name, **params}`` spec to a ``ScenarioConfig``."""
    _ensure_builtin_scenarios()
    s = dict(scenario_spec)
    base = s.pop("base", None)
    if base not in _SCENARIO_BUILDERS:
        raise ValueError(
            f"unknown scenario base {base!r}; known: {scenario_names()}")
    return _SCENARIO_BUILDERS[base](**s)


# ---------------------------------------------------------------------------
# failure-process registry
# ---------------------------------------------------------------------------

def _build_exponential(*, mtbf_s):
    return failures.Exponential(mtbf_s)


def _build_weibull(*, k, mtbf_s=None, scale_s=None):
    if (mtbf_s is None) == (scale_s is None):
        raise ValueError("weibull spec needs exactly one of mtbf_s | scale_s")
    if mtbf_s is not None:
        return failures.Weibull.from_mtbf(k, mtbf_s)
    return failures.Weibull(k=k, scale_s=scale_s)


def _build_lognormal(*, sigma, mtbf_s=None, mu=None):
    if (mtbf_s is None) == (mu is None):
        raise ValueError("lognormal spec needs exactly one of mtbf_s | mu")
    if mtbf_s is not None:
        return failures.LogNormal.from_mtbf(mtbf_s, sigma)
    return failures.LogNormal(mu=mu, sigma=sigma)


def _build_gamma(*, k, mtbf_s=None, scale_s=None):
    if (mtbf_s is None) == (scale_s is None):
        raise ValueError("gamma spec needs exactly one of mtbf_s | scale_s")
    if mtbf_s is not None:
        return failures.Gamma.from_mtbf(k, mtbf_s)
    return failures.Gamma(k=k, scale_s=scale_s)


_PROCESS_BUILDERS = {
    "exponential": _build_exponential,
    "weibull": _build_weibull,
    "lognormal": _build_lognormal,
    "gamma": _build_gamma,
}


def build_process(process_spec: Mapping) -> failures.FailureProcess:
    """Resolve a ``{"kind": ..., **params}`` spec to a ``FailureProcess``."""
    p = dict(process_spec)
    kind = p.pop("kind", None)
    if kind not in _PROCESS_BUILDERS:
        raise ValueError(
            f"unknown process kind {kind!r}; known: {sorted(_PROCESS_BUILDERS)}")
    return _PROCESS_BUILDERS[kind](**p)


# ---------------------------------------------------------------------------
# topology registry (correlated shocks — core.topology)
# ---------------------------------------------------------------------------

TOPOLOGY_KEYS = ("kind", "rack_size", "shock_mtbs_s", "p_kill", "age_boost_s")


def build_topology(topology_spec: Mapping, n_nodes: int):
    """Resolve a ``{"kind": "rack", ...}`` spec to a ``core.topology.
    Topology`` over the scenario's ``n_nodes`` (the node count lives with
    the scenario, so topology specs stay scenario-portable)."""
    from repro_torch.core import topology as node_topology

    t = dict(topology_spec)
    kind = t.pop("kind", None)
    if kind != "rack":
        raise ValueError(f"unknown topology kind {kind!r}; known: ['rack']")
    return node_topology.rack_topology(
        n_nodes, int(t.pop("rack_size")),
        shock_mtbs_s=float(t.pop("shock_mtbs_s")),
        p_kill=float(t.pop("p_kill", 1.0)),
        age_boost_s=float(t.pop("age_boost_s", 0.0)))


# ---------------------------------------------------------------------------
# fragments, axes, matrices
# ---------------------------------------------------------------------------

POLICY_KNOBS = ("ckpt_interval", "mu1", "mu2", "wait_mode",
                "move_ahead_frac", "move_ahead")
TOP_KEYS = ("scenario", "policy", "process", "topology", "run", "seed")
RUN_KEYS = ("n_runs", "max_failures", "makespan_s", "work_s")


def _deep_merge(a: Mapping, b: Mapping, path: str = "") -> dict:
    """Merge ``b`` over ``a``; same-key dicts merge recursively, a scalar
    key present in both with different values is a composition error (two
    axes claiming the same knob), identical values are tolerated."""
    out = dict(a)
    for k, v in b.items():
        here = f"{path}{k}"
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v, here + ".")
        elif k in out and out[k] != v:
            raise ValueError(
                f"conflicting values for {here!r}: {out[k]!r} vs {v!r} "
                "(two axes set the same field)")
        else:
            out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class Cell:
    """One matrix cell: axis labels + the (possibly partial) config."""

    labels: tuple          # ((axis, label), ...) in composition order
    config: dict

    @property
    def label_dict(self) -> dict:
        return dict(self.labels)

    def cell_id(self) -> str:
        return "/".join(f"{a}={l}" for a, l in self.labels)


@dataclasses.dataclass(frozen=True)
class Matrix:
    """An immutable set of cells built by axis composition."""

    cells: tuple

    def __len__(self) -> int:
        return len(self.cells)

    def __mul__(self, other: "Matrix") -> "Matrix":
        """Cartesian product: every pairing of cells, fragments merged."""
        out = []
        for a in self.cells:
            for b in other.cells:
                out.append(Cell(labels=a.labels + b.labels,
                                config=_deep_merge(a.config, b.config)))
        return Matrix(cells=tuple(out))

    def zip(self, other: "Matrix") -> "Matrix":
        """Pairwise merge of two equal-length matrices (a 'diagonal' axis:
        e.g. each scenario with its own matched MTBF)."""
        if len(self) != len(other):
            raise ValueError(
                f"zip needs equal lengths (got {len(self)} vs {len(other)})")
        return Matrix(cells=tuple(
            Cell(labels=a.labels + b.labels,
                 config=_deep_merge(a.config, b.config))
            for a, b in zip(self.cells, other.cells)))

    def filter(self, pred: Callable[[dict, dict], bool]) -> "Matrix":
        """Keep cells where ``pred(label_dict, config)`` is true."""
        return Matrix(cells=tuple(
            c for c in self.cells if pred(c.label_dict, c.config)))


def axis(name: str, values) -> Matrix:
    """One named axis.  ``values`` maps label -> config fragment (a dict),
    or is a sequence of (label, fragment) pairs when ordering matters
    beyond insertion order."""
    if isinstance(values, Mapping):
        items = list(values.items())
    else:
        items = [(str(l), f) for l, f in values]
    if not items:
        raise ValueError(f"axis {name!r} has no values")
    labels = [l for l, _ in items]
    if len(set(labels)) != len(labels):
        raise ValueError(f"axis {name!r} has duplicate labels")
    return Matrix(cells=tuple(
        Cell(labels=((name, label),), config=dict(fragment))
        for label, fragment in items))


# ---------------------------------------------------------------------------
# validation / normalization and the resolved campaign
# ---------------------------------------------------------------------------

def _norm_scalar(path: str, v):
    if isinstance(v, bool) or isinstance(v, (str, int)):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"{path}: non-finite float {v!r}")
        return v
    # numpy scalars and friends: coerce through item() so the canonical
    # JSON (and hence the content hash) never depends on the array library
    if hasattr(v, "item"):
        return _norm_scalar(path, v.item())
    raise ValueError(f"{path}: unsupported value {v!r} (JSON scalars only)")


def normalize_config(config: Mapping) -> dict:
    """Validate one cell config and return its canonical (plain-python,
    fully typed) form — the dict the content hash is computed over."""
    unknown = sorted(set(config) - set(TOP_KEYS))
    if unknown:
        raise ValueError(f"unknown cell keys {unknown}; allowed: {TOP_KEYS}")

    scenario = config.get("scenario")
    if not isinstance(scenario, Mapping) or "base" not in scenario:
        raise ValueError("cell needs scenario: {'base': <name>, ...}")
    _ensure_builtin_scenarios()
    if scenario["base"] not in _SCENARIO_BUILDERS:
        raise ValueError(
            f"unknown scenario base {scenario['base']!r}; "
            f"known: {scenario_names()}")
    out = {"scenario": {
        k: (v if k == "base" else _norm_scalar(f"scenario.{k}", v))
        for k, v in scenario.items()}}

    policy = config.get("policy")
    if policy is not None:
        bad = sorted(set(policy) - set(POLICY_KNOBS))
        if bad:
            raise ValueError(
                f"unknown policy knobs {bad}; allowed: {POLICY_KNOBS}")
        pol = {}
        for k, v in policy.items():
            v = _norm_scalar(f"policy.{k}", v)
            if k == "wait_mode":
                v = int(v)
            elif k == "move_ahead":
                v = bool(v)
            else:
                v = float(v)
            pol[k] = v
        if pol:
            out["policy"] = pol

    process = config.get("process")
    if not isinstance(process, Mapping) or \
            process.get("kind") not in _PROCESS_BUILDERS:
        raise ValueError(
            "cell needs process: {'kind': <"
            + "|".join(sorted(_PROCESS_BUILDERS)) + ">, ...}")
    out["process"] = {
        k: (v if k == "kind" else float(_norm_scalar(f"process.{k}", v)))
        for k, v in process.items()}
    build_process(out["process"])      # parameter validation

    topology = config.get("topology")
    if topology is not None:
        bad = sorted(set(topology) - set(TOPOLOGY_KEYS))
        if bad:
            raise ValueError(
                f"unknown topology keys {bad}; allowed: {TOPOLOGY_KEYS}")
        t = {}
        for k, v in topology.items():
            if k == "kind":
                t[k] = str(v)
            elif k == "rack_size":
                t[k] = int(_norm_scalar(f"topology.{k}", v))
            else:
                t[k] = float(_norm_scalar(f"topology.{k}", v))
        build_topology(t, max(t.get("rack_size", 1), 2))  # kind/param check
        out["topology"] = t

    run = config.get("run")
    if not isinstance(run, Mapping):
        raise ValueError("cell needs run: {n_runs, max_failures, "
                         "makespan_s | work_s}")
    bad = sorted(set(run) - set(RUN_KEYS))
    if bad:
        raise ValueError(f"unknown run keys {bad}; allowed: {RUN_KEYS}")
    if ("makespan_s" in run) == ("work_s" in run):
        raise ValueError("run needs exactly one of makespan_s | work_s")
    r = {"n_runs": int(run.get("n_runs", 0)),
         "max_failures": int(run.get("max_failures", 0))}
    if r["n_runs"] < 1 or r["max_failures"] < 1:
        raise ValueError("run.n_runs and run.max_failures must be >= 1")
    for k in ("makespan_s", "work_s"):
        if k in run:
            r[k] = float(_norm_scalar(f"run.{k}", run[k]))
            if r[k] <= 0:
                raise ValueError(f"run.{k} must be positive")
    out["run"] = r

    out["seed"] = int(config.get("seed", 0))
    return out


@dataclasses.dataclass(frozen=True)
class ResolvedCell:
    """A validated matrix cell, ready for hashing and dispatch."""

    labels: tuple        # ((axis, label), ...)
    config: dict         # normalize_config output

    @property
    def label_dict(self) -> dict:
        return dict(self.labels)

    def cell_id(self) -> str:
        return "/".join(f"{a}={l}" for a, l in self.labels)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A named, validated campaign: the unit the runner executes."""

    name: str
    cells: tuple         # of ResolvedCell

    def __len__(self) -> int:
        return len(self.cells)


def campaign(name: str, matrix: Matrix,
             base: Optional[Mapping] = None) -> CampaignSpec:
    """Merge each matrix fragment over ``base``, validate, and freeze.

    Validation is eager: a campaign that constructs will also resolve and
    dispatch (modulo engine preconditions like the checkpoint-interval
    floor, which depend on scenario numerics and are raised at run time
    with the offending cell named).
    """
    cells = []
    seen = {}
    for c in matrix.cells:
        merged = _deep_merge(base or {}, c.config)
        cfg = normalize_config(merged)
        cell = ResolvedCell(labels=c.labels, config=cfg)
        dup = seen.get(_freeze(cfg))
        if dup is not None:
            raise ValueError(
                f"cells {dup} and {cell.cell_id()} resolve to the same "
                "config — collapse the redundant axis values")
        seen[_freeze(cfg)] = cell.cell_id()
        cells.append(cell)
    if not cells:
        raise ValueError(f"campaign {name!r} has no cells")
    return CampaignSpec(name=name, cells=tuple(cells))


def _freeze(obj):
    if isinstance(obj, Mapping):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# resolution to engine objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolvedExperiment:
    """Engine-facing view of one cell: what the runner stacks/dispatches."""

    cfg: ScenarioConfig              # scenario with policy applied
    process: failures.FailureProcess
    n_runs: int
    max_failures: int
    makespan_s: float
    seed: int
    topology: Optional[object] = None  # core.topology.Topology (correlated)


def resolve(config: Mapping) -> ResolvedExperiment:
    """Build the engine objects for one normalized cell config."""
    from repro_torch.core import optimize   # local: avoid import cycle at startup

    cfg = build_scenario(config["scenario"])
    policy = config.get("policy")
    if policy:
        cfg = apply_policy(cfg, **policy)
    proc = build_process(config["process"])
    run = config["run"]
    if "work_s" in run:
        makespan = float(optimize.wall_makespan(
            run["work_s"], cfg.ckpt_interval, cfg.ckpt_duration))
    else:
        makespan = run["makespan_s"]
    topo_spec = config.get("topology")
    topo = None
    if topo_spec is not None:
        topo = build_topology(topo_spec, len(cfg.survivors) + 1)
    return ResolvedExperiment(
        cfg=cfg, process=proc, n_runs=run["n_runs"],
        max_failures=run["max_failures"], makespan_s=makespan,
        seed=config["seed"], topology=topo)
