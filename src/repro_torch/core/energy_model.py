"""The paper's energy model (eqs. (1)-(15)) on torch tensors.

Counterpart of ``repro.core.energy_model``.  Every function is generic over
the floating dtype of its inputs: the float64 host oracle
(``sweep.renewal_compose``) and the float32 plain version of the renewal
kernel (``kernels.renewal_scan.renewal_scan_reference``) both call it.

Shapes follow the reference: node inputs broadcast over a batch shape and
the per-level eqs. (4)-(13) add a trailing frequency-ladder axis ``F``.
``LadderArrays`` keeps the ladder axis *first*: ``(F,)`` for one profile,
or ``(F, *batch)`` for per-lane ladders (the kernel's plain version), so
``ladder.beta[f]`` is always level ``f`` broadcast against the batch.  The
vectorized per-level equations below need the ``(F,)`` form.

Notation and model conventions: see the reference module (paper Table 2,
validated against Table 4).
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch._device import resolve_device
from repro_torch.core.characterization import PowerTable, SleepSpec

__all__ = [
    "WaitMode",
    "WaitAction",
    "LadderArrays",
    "SleepArrays",
    "comp_time",
    "comp_energy",
    "take_level",
    "wait_time",
    "awake_wait_energy",
    "sleep_wait_energy",
    "sleep_allowed",
    "reference_energy",
    "intervention_energy",
    "t_failed_from_recovery",
    "t_recover",
]


class WaitMode(enum.IntEnum):
    """How the runtime is configured to wait on messages (paper §2.1)."""

    ACTIVE = 0   # spin: dissipates application power at the spinning frequency
    IDLE = 1     # block: dissipates ~base power


class WaitAction(enum.IntEnum):
    """Selected action for the waiting phase (paper §3.2)."""

    NONE = 0       # idle wait, nothing to do
    MIN_FREQ = 1   # active wait pinned to the minimum ladder frequency
    SLEEP = 2      # ACPI S-state for the bulk of the wait


@dataclasses.dataclass(frozen=True)
class LadderArrays:
    """Tensor view of a PowerTable; ladder axis first."""

    freq_ghz: torch.Tensor
    p_comp: torch.Tensor
    beta: torch.Tensor
    p_ckpt: torch.Tensor
    gamma: torch.Tensor

    @classmethod
    def from_table(cls, table: PowerTable, dtype=torch.float32,
                   device="cuda") -> "LadderArrays":
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(freq_ghz=t(table.freq_ghz), p_comp=t(table.p_comp),
                   beta=t(table.beta), p_ckpt=t(table.p_ckpt),
                   gamma=t(table.gamma))

    @property
    def num_levels(self) -> int:
        return int(self.freq_ghz.shape[0])


@dataclasses.dataclass(frozen=True)
class SleepArrays:
    """Tensor view of a SleepSpec."""

    t_go_sleep: torch.Tensor
    t_wakeup: torch.Tensor
    p_go_sleep: torch.Tensor
    p_wakeup: torch.Tensor
    p_sleep: torch.Tensor

    @classmethod
    def from_spec(cls, spec: SleepSpec, dtype=torch.float32,
                  device="cuda") -> "SleepArrays":
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(t_go_sleep=t(spec.t_go_sleep), t_wakeup=t(spec.t_wakeup),
                   p_go_sleep=t(spec.p_go_sleep), p_wakeup=t(spec.p_wakeup),
                   p_sleep=t(spec.p_sleep))

    @property
    def transition_time(self) -> torch.Tensor:
        return self.t_go_sleep + self.t_wakeup

    @property
    def transition_energy(self) -> torch.Tensor:
        return self.t_go_sleep * self.p_go_sleep + self.t_wakeup * self.p_wakeup


# ---------------------------------------------------------------------------
# eqs (4)-(6): computation phase
# ---------------------------------------------------------------------------

def _ladderize(n_ckpt, per_level: bool):
    """n_ckpt is either per-node (...,) or already per-(node, level) (..., F)."""
    return n_ckpt if per_level else n_ckpt[..., None]


def take_level(a: torch.Tensor, level):
    """Gather the trailing ladder axis of ``a`` at per-node ``level``.

    ``a`` is (..., F); ``level`` is a python int (the static-slice case, e.g.
    the paper's fa reference level 0) or an integer tensor that broadcasts
    against the node batch shape.
    """
    if isinstance(level, int):
        return a[..., level]
    level = torch.as_tensor(level, device=a.device).long()
    shape = torch.broadcast_shapes(a.shape[:-1], level.shape)
    a = a.expand(shape + a.shape[-1:])
    idx = level.expand(shape)[..., None]
    return torch.gather(a, -1, idx)[..., 0]


def comp_time(t_comp_fa, n_ckpt, t_ckpt, ladder: LadderArrays, *,
              per_level_n_ckpt=False):
    """eq (5) exec term (T_comp * beta) plus eq (6) checkpoint term
    (N_ckpt * T_ckpt * gamma).  Shapes: inputs (...,), output (..., F)."""
    n_ckpt = _ladderize(n_ckpt, per_level_n_ckpt)
    return t_comp_fa[..., None] * ladder.beta + n_ckpt * t_ckpt * ladder.gamma


def comp_energy(t_comp_fa, n_ckpt, t_ckpt, ladder: LadderArrays, *,
                per_level_n_ckpt=False):
    """eq (4): E_comp = T_comp(f)*P_comp(f) + N_ckpt*T_ckpt(f)*P_ckpt(f)."""
    n_ckpt = _ladderize(n_ckpt, per_level_n_ckpt)
    exec_e = t_comp_fa[..., None] * ladder.beta * ladder.p_comp
    ckpt_e = n_ckpt * t_ckpt * ladder.gamma * ladder.p_ckpt
    return exec_e + ckpt_e


# ---------------------------------------------------------------------------
# eqs (9)-(13): waiting phase
# ---------------------------------------------------------------------------

def wait_time(t_failed, comp_t):
    """eq (13): T_wait = T_failed - comp phase duration.  (..., F)."""
    return t_failed[..., None] - comp_t


def awake_wait_energy(wait_t, wait_mode, ladder: LadderArrays, p_idle_wait, *,
                      spin_level: int):
    """eqs (7)/(10)/(11): active waits spin at ``spin_level`` of the ladder,
    idle waits draw ``p_idle_wait`` regardless of frequency."""
    p_active = ladder.p_comp[spin_level]
    active = wait_mode == int(WaitMode.ACTIVE)
    p_wait = torch.where(active, p_active, p_idle_wait)
    return torch.clamp_min(wait_t, 0.0) * p_wait


def sleep_wait_energy(wait_t, sleep: SleepArrays):
    """eqs (9)+(12): transition energy + sleeping at P_sleep for the rest."""
    t_sleep = torch.clamp_min(wait_t - sleep.transition_time, 0.0)
    return sleep.transition_energy + t_sleep * sleep.p_sleep


def sleep_allowed(wait_t, e_sleep, e_awake, sleep: SleepArrays, mu1, mu2):
    """eq (8) gating: wait long enough AND sleeping actually cheaper."""
    long_enough = wait_t > mu1 * sleep.transition_time
    cheaper = e_sleep < mu2 * e_awake
    return long_enough & cheaper


# ---------------------------------------------------------------------------
# eqs (1)-(3): node energy with / without intervention
# ---------------------------------------------------------------------------

def reference_energy(t_comp_fa, t_failed, n_ckpt, t_ckpt, ladder: LadderArrays,
                     wait_mode, p_idle_wait, *, per_level_n_ckpt=False,
                     ref_level: int = 0):
    """eq (2): ENI — case B, continue at ``ref_level`` with no wait action."""
    ct = take_level(comp_time(t_comp_fa, n_ckpt, t_ckpt, ladder,
                              per_level_n_ckpt=per_level_n_ckpt), ref_level)
    ce = take_level(comp_energy(t_comp_fa, n_ckpt, t_ckpt, ladder,
                                per_level_n_ckpt=per_level_n_ckpt), ref_level)
    we = awake_wait_energy(t_failed - ct, wait_mode, ladder, p_idle_wait,
                           spin_level=ref_level)
    return ce + we


def intervention_energy(t_comp_fa, t_failed, n_ckpt, t_ckpt,
                        ladder: LadderArrays, sleep: SleepArrays, wait_mode,
                        p_idle_wait, mu1=6.0, mu2=1.0, per_level_n_ckpt=False):
    """eq (3) for every ladder level: EI(f) plus the per-level wait decision.

    Returns a dict of (..., F) tensors: ``total`` (inf where infeasible),
    ``feasible``, ``sleeps``, ``comp_t``, ``wait_t``, ``e_comp``,
    ``e_wait``, ``e_awake``, ``e_sleep``.
    """
    ct = comp_time(t_comp_fa, n_ckpt, t_ckpt, ladder,
                   per_level_n_ckpt=per_level_n_ckpt)
    # small relative tolerance: arriving exactly on time is feasible and
    # must not be lost to float32 rounding
    feasible = ct <= t_failed[..., None] * (1.0 + 1e-6) + 1e-3
    wt = wait_time(t_failed, ct)
    e_comp = comp_energy(t_comp_fa, n_ckpt, t_ckpt, ladder,
                         per_level_n_ckpt=per_level_n_ckpt)
    e_awake = awake_wait_energy(wt, wait_mode[..., None], ladder, p_idle_wait,
                                spin_level=ladder.num_levels - 1)
    e_sleep = sleep_wait_energy(wt, sleep)
    sleeps = sleep_allowed(wt, e_sleep, e_awake, sleep, mu1, mu2)
    e_wait = torch.where(sleeps, e_sleep, e_awake)
    total = torch.where(feasible, e_comp + e_wait, torch.inf)
    return {"total": total, "feasible": feasible, "sleeps": sleeps,
            "comp_t": ct, "wait_t": wt, "e_comp": e_comp, "e_wait": e_wait,
            "e_awake": e_awake, "e_sleep": e_sleep}


def t_failed_from_recovery(t_recover, alpha_ji, i_comm):
    """eq (14): T_failed = T_recover + alpha_ji * I_comm."""
    return t_recover + alpha_ji * i_comm


def t_recover(t_down, t_restart, t_reexec):
    """eq (15)."""
    return t_down + t_restart + t_reexec
