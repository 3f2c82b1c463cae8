"""Core of the port: energy model, planning closed forms and planners,
Algorithm 1, scenario configs and the failure-instant shift, the event
oracle and Table 4, failure processes and the correlated-failure topology,
the failure-time sweep and its Monte-Carlo, the renewal engines and the
policy grid (counterparts of ``repro.core``).  The names exported here are
those the reference's ``repro.core`` exports from the ported modules."""
from repro_torch.core.characterization import (
    MachineProfile,
    PowerTable,
    SleepSpec,
    paper_machine_profile,
    paper_power_table,
    paper_sleep_spec,
    tpu_v5e_like_profile,
)
from repro_torch.core.failures import (
    EmpiricalTrace,
    Exponential,
    FailureProcess,
    Gamma,
    LogNormal,
    Weibull,
    fit_weibull,
)

__all__ = [
    "MachineProfile",
    "PowerTable",
    "SleepSpec",
    "paper_machine_profile",
    "paper_power_table",
    "paper_sleep_spec",
    "tpu_v5e_like_profile",
    "FailureProcess",
    "Exponential",
    "Weibull",
    "LogNormal",
    "Gamma",
    "EmpiricalTrace",
    "fit_weibull",
]
