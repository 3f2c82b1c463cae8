"""FT runtime of the port: energy-aware trainer + online adaptive
controller (the counterparts of ``repro.ft``)."""
from repro_torch.ft.controller import (
    AdaptiveController,
    ReconcileReport,
    RetuneRecord,
    StochasticFailureInjector,
    cluster_scenario,
    reconcile_ledger,
)
from repro_torch.ft.runtime import (
    ClusterSpec,
    EnergyEvent,
    EnergyManager,
    FailureInjector,
    FTTrainer,
)

__all__ = [
    "AdaptiveController",
    "ReconcileReport",
    "RetuneRecord",
    "StochasticFailureInjector",
    "cluster_scenario",
    "reconcile_ledger",
    "ClusterSpec",
    "EnergyEvent",
    "EnergyManager",
    "FailureInjector",
    "FTTrainer",
]
