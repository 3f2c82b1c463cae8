"""Fleet-scale policy advisory: batched multi-cluster tuning, one scan per
shape bucket.

Counterpart of ``repro.fleet``: describe each cluster with a
``ClusterProfile``, hand a batch of them to a ``FleetAdvisor``, and get
back per-cluster tuned policies (grid optimum, Pareto knee) — grouped into
shape buckets, padded with inert lanes, answered by one ``(C, P)`` scan per
bucket on the advisor's device, and bit-identical to standalone
per-cluster ``optimize_policy`` calls at the same key.
"""
from repro_torch.fleet.advisor import Advisory, FleetAdvisor
from repro_torch.fleet.cache import CacheStats, DispatchCache
from repro_torch.fleet.profiles import (ClusterProfile, cluster_scenario,
                                        synthetic_fleet)

__all__ = [
    "Advisory",
    "FleetAdvisor",
    "CacheStats",
    "DispatchCache",
    "ClusterProfile",
    "cluster_scenario",
    "synthetic_fleet",
]
