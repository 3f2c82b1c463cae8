"""Failure processes: the inter-failure-gap distribution axis.

Counterpart of ``repro.core.failures`` for ``Exponential`` and ``Weibull``
(``LogNormal``, ``Gamma``, ``EmpiricalTrace``, ``fit_weibull`` and the KS
helpers arrive in the next slice — ROADMAP Queue 1).

``residual(v, age)`` is the age-conditioned inverse CDF of a raw uniform
draw ``v`` (survival draw ``u = 1 - v``); the exponential drops the age.
``sample_renewal_gaps`` runs the competing-risks recursion of the
reference: the epoch gap is the minimum over nodes and the failing node the
argmin; non-memoryless processes carry per-node failure-clock ages.  Draws
come from ``core.prng`` (threefry, bit-compatible uniforms with
``jax.random``) and the transforms are float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng

__all__ = [
    "FailureProcess",
    "Exponential",
    "Weibull",
    "as_process",
    "sample_renewal_gaps",
    "failure_clock_ages",
]


def _gamma_fn(x) -> np.ndarray:
    """Elementwise Gamma function in float64."""
    x = np.asarray(x, np.float64)
    return np.exp(np.vectorize(math.lgamma, otypes=[np.float64])(x))


def _param(x) -> np.ndarray:
    """Process parameters are stored as concrete float32 (as the reference)."""
    return np.asarray(x, np.float32)


def _check_positive(name: str, x) -> None:
    if np.any(np.asarray(x, np.float64) <= 0.0):
        raise ValueError(f"{name} must be positive, got {x}")


def _t32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


class FailureProcess:
    """Base: one node's inter-failure gap distribution.

    Parameters broadcast against a trailing node axis.  ``residual`` is the
    float32 age-conditioned inverse-CDF transform the samplers call;
    ``survival``/``cdf``/``mean_s`` are float64 host numpy.
    """

    def residual(self, v: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def survival(self, t) -> np.ndarray:
        raise NotImplementedError

    def cdf(self, t) -> np.ndarray:
        return 1.0 - self.survival(t)

    def mean_s(self) -> np.ndarray:
        raise NotImplementedError

    def label(self) -> str:
        raise NotImplementedError

    def sample(self, key, shape, device="cuda") -> torch.Tensor:
        """Unconditional (age-0) float32 gap draws of ``shape`` on
        ``device`` (for ``Exponential``, ``mtbf_s * prng.exponential``)."""
        v = prng.uniform(key, shape, device)
        return self.residual(v, torch.zeros_like(v))


@dataclasses.dataclass(frozen=True)
class Exponential(FailureProcess):
    """Memoryless gaps, mean ``mtbf_s`` — the paper's failure process."""

    mtbf_s: Any

    def __post_init__(self):
        object.__setattr__(self, "mtbf_s", _param(self.mtbf_s))
        _check_positive("mtbf_s", self.mtbf_s)

    def residual(self, v, age):
        del age                      # memoryless: the age drops out
        return _t32(self.mtbf_s, v) * (-torch.log1p(-v))

    def survival(self, t):
        return np.exp(-np.asarray(t, np.float64)
                      / np.asarray(self.mtbf_s, np.float64))

    def mean_s(self):
        return np.asarray(self.mtbf_s, np.float64)

    def label(self):
        return f"exponential(mtbf={np.mean(self.mean_s()):g}s)"


@dataclasses.dataclass(frozen=True)
class Weibull(FailureProcess):
    """Weibull(k, scale): S(t) = exp(-(t/scale)^k).  k < 1 is infant
    mortality, k > 1 wear-out, k = 1 the exponential."""

    k: Any
    scale_s: Any

    def __post_init__(self):
        object.__setattr__(self, "k", _param(self.k))
        object.__setattr__(self, "scale_s", _param(self.scale_s))
        _check_positive("k", self.k)
        _check_positive("scale_s", self.scale_s)

    @classmethod
    def from_mtbf(cls, k, mtbf_s) -> "Weibull":
        """Shape ``k`` with the scale chosen so the mean gap is ``mtbf_s``
        (mean = scale * Gamma(1 + 1/k))."""
        k64 = np.asarray(k, np.float64)
        scale = np.asarray(mtbf_s, np.float64) / _gamma_fn(1.0 + 1.0 / k64)
        return cls(k=k, scale_s=scale)

    def residual(self, v, age):
        k = _t32(self.k, v)
        lam = _t32(self.scale_s, v)
        e = -torch.log1p(-v)                     # unit exponential draw
        # S(a+T)/S(a) = u  <=>  ((a+T)/lam)^k = (a/lam)^k + e
        za = (age / lam) ** k
        return torch.clamp_min(lam * (za + e) ** (1.0 / k) - age, 0.0)

    def survival(self, t):
        t = np.asarray(t, np.float64)
        return np.exp(-(t / np.asarray(self.scale_s, np.float64))
                      ** np.asarray(self.k, np.float64))

    def mean_s(self):
        k = np.asarray(self.k, np.float64)
        return np.asarray(self.scale_s, np.float64) * _gamma_fn(1.0 + 1.0 / k)

    def label(self):
        return (f"weibull(k={np.mean(np.asarray(self.k, np.float64)):g},"
                f"mtbf={np.mean(self.mean_s()):g}s)")


def as_process(process: Optional[FailureProcess], mtbf_s=None) -> FailureProcess:
    """``process=None`` means the paper's exponential at ``mtbf_s``."""
    if process is None:
        if mtbf_s is None:
            raise ValueError("provide a FailureProcess or an mtbf_s")
        return Exponential(mtbf_s)
    if not isinstance(process, FailureProcess):
        raise TypeError(f"not a FailureProcess: {process!r}")
    return process


def sample_renewal_gaps(process: FailureProcess, key, n_runs: int,
                        max_failures: int, n_nodes: int, device="cuda"):
    """Renewal-epoch gaps under the quiesce policy: ``(gaps, failed_node)``
    of shape ``(n_runs, max_failures)``, float32 and int64, on ``device``.

    Exponential processes take the closed form (fresh draws per epoch, gap =
    min, failing node = argmin); every other process runs the conditional-
    residual recursion with per-node failure-clock ages (start at zero,
    survivors advance by the gap, the failed clock resets).
    """
    dev = resolve_device(device)
    if isinstance(process, Exponential):
        draws = prng.exponential(key, (n_runs, max_failures, n_nodes), dev) \
            * _t32(process.mtbf_s, torch.empty(0, device=dev))
        return torch.amin(draws, dim=-1), torch.argmin(draws, dim=-1)

    v = prng.uniform(key, (max_failures, n_runs, n_nodes), dev)
    ages = torch.zeros((n_runs, n_nodes), dtype=torch.float32, device=dev)
    node = torch.arange(n_nodes, device=dev)
    gaps, failed = [], []
    for k in range(max_failures):
        t = process.residual(v[k], ages)                     # (R, N)
        gap = torch.amin(t, dim=-1)
        f = torch.argmin(t, dim=-1)
        ages = torch.where(node == f[:, None], 0.0, ages + gap[:, None])
        gaps.append(gap)
        failed.append(f)
    return torch.stack(gaps, dim=1), torch.stack(failed, dim=1)


def failure_clock_ages(gaps, failed_node, n_nodes: int) -> np.ndarray:
    """Replay ``sample_renewal_gaps``'s clock recursion from a sampled
    history ``(gaps, failed_node)`` of shape ``(R, K)`` (or ``(K,)``):
    float64 ``(R, K, n_nodes)`` per-node failure-clock ages at each renewal
    anchor (host numpy, as the reference)."""
    gaps = np.atleast_2d(np.asarray(gaps, np.float64))
    failed = np.atleast_2d(np.asarray(failed_node, np.int64))
    if gaps.shape != failed.shape:
        raise ValueError(f"gaps {gaps.shape} and failed_node {failed.shape} "
                         "must share their (R, K) shape")
    if failed.size and (failed.min() < 0 or failed.max() >= n_nodes):
        raise ValueError(f"failed_node entries outside [0, {n_nodes})")
    n_runs, max_failures = gaps.shape
    ages = np.zeros((n_runs, max_failures, n_nodes))
    a = np.zeros((n_runs, n_nodes))
    rows = np.arange(n_runs)
    for k in range(max_failures):
        ages[:, k] = a
        a = a + gaps[:, k][:, None]
        a[rows, failed[:, k]] = 0.0
    return ages
