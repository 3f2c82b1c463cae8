"""Scenario configuration dataclasses (``NodeStart``, ``ScenarioConfig``).

The config half of ``repro.core.simulator``, copied so the port never
imports the reference.  The event oracle ``simulate``/``simulate_run``
arrives in the next slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import energy_model as em
from repro_torch.core.characterization import MachineProfile, paper_machine_profile

__all__ = ["NodeStart", "ScenarioConfig"]


@dataclasses.dataclass(frozen=True)
class NodeStart:
    """Pre-failure state of a surviving node at the failure instant (t=0).

    ``peer``: 0 = rendezvous with the failed process; i > 0 = with survivor
    i (a blocking chain).  ``level`` is the node's current DVFS ladder level
    (0 = fa).  Semantics as in the reference.
    """

    exec_to_rendezvous: float      # fa-seconds of work until the next rendezvous
    rendezvous_period: float = 3600.0
    ckpt_age: float = 60.0         # wall seconds since last checkpoint end
    peer: int = 0                  # 0 = the failed process; i>0 = survivor i
    level: int = 0                 # current DVFS ladder level (0 = fa)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    name: str
    survivors: tuple
    t_down: float
    t_restart: float
    t_reexec: float
    profile: MachineProfile = dataclasses.field(default_factory=paper_machine_profile)
    ckpt_interval: float = 3600.0
    ckpt_duration: float = 120.0
    wait_mode: em.WaitMode = em.WaitMode.ACTIVE
    move_ahead: bool = True
    move_ahead_frac: float = 0.5
    mu1: float = 6.0
    mu2: float = 1.0

    @property
    def t_recover(self) -> float:
        return self.t_down + self.t_restart + self.t_reexec
