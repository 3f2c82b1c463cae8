"""Machine characterization inputs for the energy model (paper Table 1/3, §4.2).

The paper's model is characterization-table driven: a ladder of frequency
levels with application power ``P_comp(f)``, checkpoint power ``P_ckpt(f)``,
and slowdown factors ``beta(f)`` / ``gamma(f)``; plus an ACPI sleep-state
specification (S3 in the paper) and the base/idle powers.

Everything is stored as plain ``numpy`` arrays so profiles can be constructed
anywhere (config files, tests) and converted to torch tensors on use
(``energy_model.LadderArrays.from_table``).  A numpy copy of
``repro.core.characterization``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "PowerTable",
    "SleepSpec",
    "MachineProfile",
    "paper_power_table",
    "paper_sleep_spec",
    "paper_machine_profile",
]


@dataclasses.dataclass(frozen=True)
class PowerTable:
    """DVFS ladder: per-frequency power and slowdown (paper Table 3).

    Arrays are sorted descending by frequency; index 0 is the maximum
    frequency (``fa`` in the paper) and index -1 the minimum.
    """

    freq_ghz: np.ndarray   # (F,) clock frequency in GHz
    p_comp: np.ndarray     # (F,) application power at f, watts
    beta: np.ndarray       # (F,) application slowdown at f  (beta[0] == 1)
    p_ckpt: np.ndarray     # (F,) checkpoint power at f, watts
    gamma: np.ndarray      # (F,) checkpoint slowdown at f (gamma[0] == 1)

    def __post_init__(self) -> None:
        for name in ("freq_ghz", "p_comp", "beta", "p_ckpt", "gamma"):
            object.__setattr__(self, name, np.asarray(getattr(self, name), dtype=np.float64))
        n = self.freq_ghz.shape[0]
        for name in ("p_comp", "beta", "p_ckpt", "gamma"):
            if getattr(self, name).shape != (n,):
                raise ValueError(f"PowerTable.{name} must have shape ({n},)")
        if n < 1:
            raise ValueError("PowerTable needs at least one frequency level")
        if not np.all(np.diff(self.freq_ghz) <= 0):
            raise ValueError("freq_ghz must be sorted descending (index 0 = max frequency)")
        if not np.isclose(self.beta[0], 1.0) or not np.isclose(self.gamma[0], 1.0):
            raise ValueError("slowdowns must be 1.0 at the maximum frequency")

    @property
    def num_levels(self) -> int:
        return int(self.freq_ghz.shape[0])

    @property
    def max_index(self) -> int:
        return 0

    @property
    def min_index(self) -> int:
        return self.num_levels - 1

    def scaled(self, p_comp_delta: float = 0.0, beta_delta: float = 0.0) -> "PowerTable":
        """Return a modified ladder (used by paper Scenario 3: ``-2 W`` power,
        ``+0.1`` slowdown on every non-maximal level)."""
        p = self.p_comp.copy()
        b = self.beta.copy()
        p[1:] += p_comp_delta
        b[1:] += beta_delta
        return dataclasses.replace(self, p_comp=p, beta=b)


@dataclasses.dataclass(frozen=True)
class SleepSpec:
    """ACPI sleeping-state characterization (paper §4.2, S3 values from [15])."""

    t_go_sleep: float   # seconds to enter the sleep state
    t_wakeup: float     # seconds to return to working state
    p_go_sleep: float   # watts while entering sleep
    p_wakeup: float     # watts while waking
    p_sleep: float      # watts while asleep

    @property
    def transition_time(self) -> float:
        return self.t_go_sleep + self.t_wakeup

    @property
    def transition_energy(self) -> float:
        return self.t_go_sleep * self.p_go_sleep + self.t_wakeup * self.p_wakeup


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Everything the energy model needs to know about a node.

    ``p_idle_wait`` is "a power near to the base power" (paper §3.3); active
    waits dissipate the application power of whatever frequency the core spins
    at, so active-wait power is read from ``power_table.p_comp``.
    """

    name: str
    power_table: PowerTable
    sleep: SleepSpec
    p_base: float          # base power, watts
    p_idle_wait: float     # idle (blocking) wait power, watts

    def active_wait_power(self, level: int) -> float:
        return float(self.power_table.p_comp[level])


def paper_power_table() -> PowerTable:
    """Table 3 of the paper (six-core Intel Xeon E5-2630, turbo disabled)."""
    return PowerTable(
        freq_ghz=np.array([2.8, 2.1, 1.7, 1.2]),
        p_comp=np.array([166.0, 148.0, 139.0, 126.0]),
        beta=np.array([1.0, 1.2, 1.5, 2.1]),
        p_ckpt=np.array([150.0, 142.0, 131.0, 125.0]),
        gamma=np.array([1.0, 1.1, 1.2, 1.4]),
    )


def paper_sleep_spec() -> SleepSpec:
    """S3 sleeping mode constants (paper §4.2, measured in [15])."""
    return SleepSpec(
        t_go_sleep=25.0,
        t_wakeup=5.0,
        p_go_sleep=51.0,
        p_wakeup=91.0,
        p_sleep=12.0,
    )


def paper_machine_profile() -> MachineProfile:
    return MachineProfile(
        name="xeon-e5-2630",
        power_table=paper_power_table(),
        sleep=paper_sleep_spec(),
        p_base=60.0,
        p_idle_wait=60.0,
    )
