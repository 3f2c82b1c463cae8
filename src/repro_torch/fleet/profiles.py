"""Operator-facing cluster profiles: the fleet advisor's request language
(counterpart of ``repro.fleet.profiles``).

A ``ClusterProfile`` is what an advisory request carries — the handful of
numbers a site operator actually knows about a job slice (node count,
rendezvous period, per-node MTBF and failure family, power class,
checkpoint cost) — and what the serving layer lowers onto the engine's
``ScenarioConfig`` + ``FailureProcess`` pair.  The lowering builds the
*balanced* snapshot: survivors evenly phased around the rendezvous
period, fresh from a coordinated checkpoint (ages 0, no lost work), which
is exactly the post-recovery renewal state the Monte-Carlo engine
re-anchors to between failures (``scenarios.post_recovery_config``), so a
profile's answer does not depend on an arbitrary mid-epoch phase choice.

``power_scale`` models the per-node power heterogeneity of
"Checkpoint and Restart: An Energy Consumption Characterization in
Clusters" (PAPERS.md): one multiplier over the whole paper ladder
(compute, checkpoint, base, wait, and sleep powers alike), leaving
slowdowns — and therefore Algorithm 1's *frequency* choice — untouched
while scaling every joule the advisor trades off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import optimize
from repro_torch.core.characterization import paper_machine_profile
from repro_torch.core.failures import Exponential, FailureProcess, Weibull
from repro_torch.core.simulator import NodeStart, ScenarioConfig

__all__ = ["ClusterProfile", "synthetic_fleet", "cluster_scenario"]

_FAMILIES = ("exponential", "weibull")


@dataclasses.dataclass(frozen=True)
class ClusterProfile:
    """One advisory request: a cluster and the job running on it.

    ``n_nodes`` counts ALL processes including the one whose failure each
    epoch models, so survivors = ``n_nodes - 1`` — the static shape the
    serving layer buckets requests by (``bucket_key``).  ``work_s`` is the
    job's remaining useful work, the equal-work horizon the policy grid is
    scored over.
    """

    name: str = "cluster"
    n_nodes: int = 4
    period_s: float = 14400.0           # rendezvous period (wall seconds)
    mtbf_s: float = 14 * 24 * 3600.0    # per-node mean time between failures
    family: str = "exponential"         # failure law: exponential | weibull
    weibull_k: float = 0.7              # shape when family == "weibull"
    power_scale: float = 1.0            # node power class vs the paper ladder
    ckpt_duration: float = 120.0
    t_down: float = 60.0
    t_restart: float = 60.0
    work_s: float = 7 * 24 * 3600.0

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError(f"{self.name}: need >= 2 nodes (one fails, "
                             f"the rest survive), got {self.n_nodes}")
        if self.family not in _FAMILIES:
            raise ValueError(f"{self.name}: unknown failure family "
                             f"{self.family!r}; known: {_FAMILIES}")
        for field in ("period_s", "mtbf_s", "weibull_k", "power_scale",
                      "ckpt_duration", "work_s"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{self.name}: {field} must be positive")

    def bucket_key(self) -> Tuple[int, str]:
        """The static-shape part of the dispatch signature: requests that
        share it can ride one fused program (the batch size is padded to a
        bucket separately — ``FleetAdvisor``)."""
        return (self.n_nodes, self.family)

    def scenario(self) -> ScenarioConfig:
        """The balanced post-recovery snapshot this profile lowers to."""
        n_surv = self.n_nodes - 1
        profile = _scaled_profile(self.power_scale)
        survivors = tuple(
            NodeStart(
                exec_to_rendezvous=self.period_s * (i + 1) / self.n_nodes,
                rendezvous_period=self.period_s,
                ckpt_age=0.0,
            )
            for i in range(n_surv))
        return ScenarioConfig(
            name=self.name,
            survivors=survivors,
            t_down=self.t_down,
            t_restart=self.t_restart,
            t_reexec=0.0,
            profile=profile,
            ckpt_duration=self.ckpt_duration,
        )

    def failure_process(self) -> FailureProcess:
        if self.family == "weibull":
            return Weibull.from_mtbf(self.weibull_k, self.mtbf_s)
        return Exponential(self.mtbf_s)

    def spec(self) -> optimize.ClusterSpec:
        """The engine-facing (scenario, process, work) triple."""
        return optimize.ClusterSpec(
            cfg=self.scenario(),
            process=self.failure_process(),
            work_s=self.work_s,
        )


def _scaled_profile(power_scale: float):
    base = paper_machine_profile()
    if power_scale == 1.0:
        return base
    pt = base.power_table
    return dataclasses.replace(
        base,
        name=f"{base.name}-x{power_scale:g}",
        power_table=dataclasses.replace(
            pt,
            p_comp=np.asarray(pt.p_comp) * power_scale,
            p_ckpt=np.asarray(pt.p_ckpt) * power_scale,
        ),
        sleep=dataclasses.replace(
            base.sleep,
            p_go_sleep=base.sleep.p_go_sleep * power_scale,
            p_wakeup=base.sleep.p_wakeup * power_scale,
            p_sleep=base.sleep.p_sleep * power_scale,
        ),
        p_base=base.p_base * power_scale,
        p_idle_wait=base.p_idle_wait * power_scale,
    )


def synthetic_fleet(n: int, *, seed: int = 0,
                    node_buckets: Tuple[int, ...] = (4, 8),
                    weibull_frac: float = 0.5) -> list:
    """A deterministic heterogeneous fleet of ``n`` profiles: node counts
    drawn from ``node_buckets``, MTBFs log-uniform in [5, 30] days, power
    classes in [0.8, 1.25], rendezvous periods in {2 h, 4 h, 8 h}, and a
    ``weibull_frac`` share of infant-mortality Weibull clusters — the same
    numpy draws as the reference's generator, so a seed names the same
    fleet on both sides."""
    if n < 1:
        raise ValueError(f"fleet size must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    day = 24 * 3600.0
    out = []
    for i in range(n):
        family = "weibull" if rng.random() < weibull_frac else "exponential"
        out.append(ClusterProfile(
            name=f"cluster{i:04d}",
            n_nodes=int(rng.choice(node_buckets)),
            period_s=float(rng.choice([7200.0, 14400.0, 28800.0])),
            mtbf_s=float(np.exp(rng.uniform(np.log(5 * day), np.log(30 * day)))),
            family=family,
            weibull_k=float(rng.uniform(0.6, 0.95)),
            power_scale=float(rng.uniform(0.8, 1.25)),
            work_s=float(rng.uniform(5 * day, 14 * day)),
        ))
    return out


def cluster_scenario(*, n_nodes: int = 4, period_s: float = 14400.0,
                     power_scale: float = 1.0, ckpt_duration: float = 120.0,
                     name: Optional[str] = None) -> ScenarioConfig:
    """Campaign-registry builder (``{"base": "fleet_cluster", ...}``):
    matrices over cluster profiles — node count / power-class axes — reuse
    the same lowering the advisor serves."""
    profile = ClusterProfile(
        name=name or f"fleet_n{n_nodes}_x{power_scale:g}",
        n_nodes=int(n_nodes),
        period_s=float(period_s),
        power_scale=float(power_scale),
        ckpt_duration=float(ckpt_duration),
    )
    return profile.scenario()
