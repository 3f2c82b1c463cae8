"""Failure processes: the inter-failure-gap distribution axis.

Counterpart of ``repro.core.failures``: ``Exponential``, ``Weibull``,
``LogNormal``, ``Gamma`` and ``EmpiricalTrace`` (per-node parameters
broadcast against a trailing node axis), ``stack_processes``, the renewal
sampler and its host entry point ``renewal_gaps``, and the host float64
statistics (``ks_statistic``, ``ks_critical``, ``fit_weibull``).

``residual(v, age)`` is the age-conditioned inverse CDF of a raw uniform
draw ``v`` (survival draw ``u = 1 - v``); the exponential drops the age.
``sample_renewal_gaps`` runs the competing-risks recursion of the
reference: the epoch gap is the minimum over nodes and the failing node the
argmin; non-memoryless processes carry per-node failure-clock ages.  Every
process drives every renewal engine through it.  Draws come from
``core.prng`` (threefry, bit-compatible uniforms with ``jax.random``) and
the transforms are float32, as in the reference.  The special functions
are the backend's own: ``log1p``, ``erf``/``erfc``, ``ndtri`` and
``gammaincc`` may differ from XLA's by a few ulp, so LogNormal and Gamma
gaps agree with the reference's to a tolerance, not bit for bit (the
tests state it).  The normal CDF is computed as the reference computes it
(``erfc`` in the tails), because ``torch.special.ndtr`` underflows to 0 in
the float32 lower tail where the reference's stays positive.
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
    "LogNormal",
    "Gamma",
    "EmpiricalTrace",
    "as_process",
    "stack_processes",
    "sample_renewal_gaps",
    "fleet_size",
    "sample_fleet_renewal_gaps",
    "renewal_gaps",
    "failure_clock_ages",
    "ks_statistic",
    "ks_critical",
    "fit_weibull",
]

_GAMMA_BISECT_ITERS = 46    # bisection steps for the gamma inverse CDF; the
                            # bracket shrinks ~2^-46, far below f32 resolution

_erfc_u = np.frompyfunc(math.erfc, 1, 1)


def _gamma_fn(x) -> np.ndarray:
    """Elementwise Gamma function in float64."""
    x = np.asarray(x, np.float64)
    return np.exp(np.vectorize(math.lgamma, otypes=[np.float64])(x))


def _ndtr_np(x) -> np.ndarray:
    """Standard-normal CDF in float64 via math.erfc."""
    return 0.5 * np.asarray(
        _erfc_u(-np.asarray(x, np.float64) / math.sqrt(2.0)), np.float64)


def _ndtr32(x: torch.Tensor) -> torch.Tensor:
    """Standard-normal CDF in float32, as ``jax.scipy.special.ndtr``:
    ``1 + erf`` near 0 and ``erfc`` in the tails, so the lower tail keeps
    its mass down to float32's smallest normals."""
    half_sqrt_2 = torch.tensor(0.5 * math.sqrt(2.0), dtype=x.dtype,
                               device=x.device)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.special.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.special.erfc(z),
                                torch.special.erfc(z)))
    return 0.5 * y


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


@dataclasses.dataclass(frozen=True)
class LogNormal(FailureProcess):
    """log(gap) ~ Normal(mu, sigma^2): heavy right tail, non-monotone hazard."""

    mu: Any
    sigma: Any

    def __post_init__(self):
        object.__setattr__(self, "mu", _param(self.mu))
        object.__setattr__(self, "sigma", _param(self.sigma))
        _check_positive("sigma", self.sigma)

    @classmethod
    def from_mtbf(cls, mtbf_s, sigma) -> "LogNormal":
        """Spread ``sigma`` with the location chosen so the mean gap is
        ``mtbf_s`` (mean = exp(mu + sigma^2 / 2))."""
        s64 = np.asarray(sigma, np.float64)
        mu = np.log(np.asarray(mtbf_s, np.float64)) - 0.5 * s64 * s64
        return cls(mu=mu, sigma=sigma)

    def residual(self, v, age):
        mu = _t32(self.mu, v)
        sigma = _t32(self.sigma, v)
        u = 1.0 - v
        s_a = torch.where(age > 0.0, _ndtr32((mu - torch.log(age)) / sigma),
                          1.0)
        # floor keeps ndtri finite when age pushes the survival mass below
        # f32 tiny (the draw then lands ~13 sigma out instead of at +inf)
        uc = torch.clamp_min(u * s_a, 1e-37)
        return torch.clamp_min(
            torch.exp(mu - sigma * torch.special.ndtri(uc)) - age, 0.0)

    def survival(self, t):
        t = np.asarray(t, np.float64)
        mu = np.asarray(self.mu, np.float64)
        sigma = np.asarray(self.sigma, np.float64)
        with np.errstate(divide="ignore"):
            z = np.where(t > 0.0, (mu - np.log(np.maximum(t, 1e-300))) / sigma,
                         np.inf)
        return _ndtr_np(z)

    def mean_s(self):
        mu = np.asarray(self.mu, np.float64)
        sigma = np.asarray(self.sigma, np.float64)
        return np.exp(mu + 0.5 * sigma * sigma)

    def label(self):
        return (f"lognormal(sigma={np.mean(np.asarray(self.sigma, np.float64)):g},"
                f"mtbf={np.mean(self.mean_s()):g}s)")


@dataclasses.dataclass(frozen=True)
class Gamma(FailureProcess):
    """Gamma(k, scale): S(t) = Q(k, t/scale) (regularized upper incomplete).

    No closed-form inverse: the residual solves ``Q(k, z) = u * Q(k, z_a)``
    by 46 fixed bisection steps on float32 ``gammaincc`` in the bracket
    ``[z_a, z_a + 32 (1 + k)]``, as the reference.  The backend's
    ``gammaincc`` is not XLA's, so a step near the root may branch the
    other way: gaps agree with the reference's to a tolerance.
    """

    k: Any
    scale_s: Any

    def __post_init__(self):
        object.__setattr__(self, "k", _param(self.k))
        object.__setattr__(self, "scale_s", _param(self.scale_s))
        _check_positive("k", self.k)
        _check_positive("scale_s", self.scale_s)

    @classmethod
    def from_mtbf(cls, k, mtbf_s) -> "Gamma":
        """Shape ``k`` with the scale chosen so the mean gap is ``mtbf_s``
        (mean = k * scale)."""
        scale = np.asarray(mtbf_s, np.float64) / np.asarray(k, np.float64)
        return cls(k=k, scale_s=scale)

    def residual(self, v, age):
        k = _t32(self.k, v)
        scale = _t32(self.scale_s, v)
        za = age / scale
        target = (1.0 - v) * torch.special.gammaincc(k, za)
        lo = torch.broadcast_to(za, target.shape)
        hi = lo + 32.0 * (1.0 + k)
        for _ in range(_GAMMA_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            right = torch.special.gammaincc(k, mid) > target  # survival above
            lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
        return torch.clamp_min(scale * (0.5 * (lo + hi)) - age, 0.0)

    def survival(self, t):
        from scipy import special as sps

        z = np.asarray(t, np.float64) / np.asarray(self.scale_s, np.float64)
        return np.asarray(sps.gammaincc(np.asarray(self.k, np.float64), z),
                          np.float64)

    def mean_s(self):
        return (np.asarray(self.k, np.float64)
                * np.asarray(self.scale_s, np.float64))

    def label(self):
        return (f"gamma(k={np.mean(np.asarray(self.k, np.float64)):g},"
                f"mtbf={np.mean(self.mean_s()):g}s)")


@dataclasses.dataclass(frozen=True)
class EmpiricalTrace(FailureProcess):
    """Gaps resampled from a supplied failure log.

    ``gaps`` is a 1-D array (one trace shared by all nodes) or 2-D
    ``(n_nodes, L)`` (per-node traces), sorted ascending at construction.
    An age-conditioned residual resamples uniformly from the sub-trace
    ``{g - age : g > age}``; a clock age beyond the trace's largest gap
    falls back to an unconditional resample (the reference's rule).
    """

    gaps: Any

    def __post_init__(self):
        g = np.sort(np.asarray(self.gaps, np.float32), axis=-1)
        if g.ndim not in (1, 2) or g.shape[-1] < 2:
            raise ValueError(
                f"trace must be (L,) or (n_nodes, L) with L >= 2, "
                f"got shape {np.shape(g)}")
        if np.any(g <= 0.0):
            raise ValueError("trace gaps must be positive")
        object.__setattr__(self, "gaps", g)

    @staticmethod
    def _residual_rows(trace, v, age):
        """The reference's ``_residual_1d``: on a (L,) trace and draws of
        any shape, or on (N, L) traces and (N, M) draws, one row a node."""
        n = trace.shape[-1]
        start = torch.searchsorted(trace, age, right=True)   # first gap > age
        exhausted = start >= n
        start = torch.where(exhausted, 0, start)
        off = torch.floor(v * (n - start).to(torch.float32)).to(start.dtype)
        idx = start + torch.minimum(off, n - 1 - start)
        raw = trace[idx] if trace.dim() == 1 else torch.gather(trace, 1, idx)
        return torch.where(exhausted, raw, torch.clamp_min(raw - age, 0.0))

    def residual(self, v, age):
        trace = _t32(self.gaps, v)
        age = torch.broadcast_to(age.to(torch.float32), v.shape).contiguous()
        if trace.dim() == 1:
            return self._residual_rows(trace, v, age)
        # per-node traces: one batched search and gather, node axis first
        rows = lambda x: x.movedim(-1, 0).reshape(trace.shape[0], -1)
        out = self._residual_rows(trace, rows(v), rows(age).contiguous())
        return out.reshape(v.movedim(-1, 0).shape).movedim(0, -1)

    def survival(self, t):
        trace = np.asarray(self.gaps, np.float64)
        t = np.asarray(t, np.float64)
        if trace.ndim == 1:
            return 1.0 - np.searchsorted(trace, t, side="right") / trace.shape[-1]
        t_b = np.broadcast_to(t, np.broadcast_shapes(t.shape, trace.shape[:1]))
        cols = [np.searchsorted(trace[i], t_b[..., i], side="right")
                for i in range(trace.shape[0])]
        return 1.0 - np.stack(cols, axis=-1) / trace.shape[-1]

    def mean_s(self):
        return np.mean(np.asarray(self.gaps, np.float64), axis=-1)

    def label(self):
        g = np.asarray(self.gaps, np.float64)
        return f"trace(n={g.shape[-1]},mtbf={np.mean(g):g}s)"


def as_process(process: Optional[FailureProcess], mtbf_s=None) -> FailureProcess:
    """``process=None`` means the paper's exponential at ``mtbf_s``."""
    if process is None:
        if mtbf_s is None:
            raise ValueError("provide a FailureProcess or an mtbf_s")
        return Exponential(mtbf_s)
    if not isinstance(process, FailureProcess):
        raise TypeError(f"not a FailureProcess: {process!r}")
    return process


def stack_processes(processes) -> FailureProcess:
    """Stack same-family processes into ONE process with a leading cluster
    axis on every parameter array (float32), as the reference: each
    cluster lane then carries exactly its standalone process's parameters.
    All members must be the same concrete class with identically shaped
    parameters (``EmpiricalTrace`` members need equal trace lengths); a
    single-member stack gives parameters of shape ``(1, ...)``."""
    procs = [as_process(p) for p in processes]
    if not procs:
        raise ValueError("no processes to stack")
    fam = type(procs[0])
    if any(type(p) is not fam for p in procs):
        raise ValueError(
            "stack_processes needs one process family per dispatch bucket, "
            f"got {sorted({type(p).__name__ for p in procs})}; route "
            "mixed-family fleets through per-family buckets (repro.fleet)")
    names = [f.name for f in dataclasses.fields(fam)]
    try:
        return fam(**{n: np.stack([np.asarray(getattr(p, n), np.float32)
                                   for p in procs]) for n in names})
    except ValueError as e:
        raise ValueError(
            f"{fam.__name__} parameter leaves do not stack (unequal "
            f"shapes across clusters): {e}") from e


def _competing_risks(residual, v: torch.Tensor, ages: torch.Tensor):
    """The conditional-residual recursion over ``v`` (K, R, N) uniforms
    from zero clock ``ages`` ((R, N), or (C, R, N) for cluster lanes):
    each epoch's gap is the minimum residual over nodes and the failing
    node the argmin; survivors' clocks advance by the gap, the failed
    clock resets.  Returns gaps and failing nodes, epochs last."""
    node = torch.arange(v.shape[-1], device=v.device)
    gaps, failed = [], []
    for k in range(v.shape[0]):
        t = residual(v[k], ages)                             # (..., R, N)
        gap = torch.amin(t, dim=-1)
        f = torch.argmin(t, dim=-1)
        ages = torch.where(node == f[..., None], 0.0, ages + gap[..., None])
        gaps.append(gap)
        failed.append(f)
    return torch.stack(gaps, dim=-1), torch.stack(failed, dim=-1)


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
    return _competing_risks(process.residual, v, ages)


def fleet_size(process: FailureProcess) -> int:
    """The cluster count ``C`` of a process stacked over cluster lanes
    (``stack_processes``): every parameter leaf has leading axis C.
    Raises ValueError for a process that is not such a stack."""
    leaves = [np.asarray(getattr(process, f.name))
              for f in dataclasses.fields(process)]
    sizes = {a.shape[0] if a.ndim else None for a in leaves}
    if len(sizes) != 1 or None in sizes:
        raise ValueError("a process stacked over cluster lanes needs a "
                         "leading cluster axis on every parameter "
                         "(failures.stack_processes)")
    return sizes.pop()


def _fleet_residual(process: FailureProcess, n_clusters: int):
    """``residual(v, ages)`` of a cluster-stacked process for (R, N) draws
    against (C, R, N) clock ages: each cluster lane transforms the shared
    draws through its own parameters, element for element what the
    standalone process computes."""
    if isinstance(process, EmpiricalTrace):
        # a stack of 1-D traces is (C, L): one gather row per cluster
        def residual(v, age):
            rows = lambda x: x.reshape(n_clusters, -1)
            out = EmpiricalTrace._residual_rows(
                _t32(process.gaps, v), rows(v.expand(age.shape)),
                rows(age).contiguous())
            return out.reshape(age.shape)
        return residual
    lanes = lambda a: a.reshape((n_clusters,) + (1,) * (3 - a.ndim)
                                + a.shape[1:])
    view = type(process)(**{f.name: lanes(np.asarray(getattr(process, f.name)))
                            for f in dataclasses.fields(process)})
    return view.residual


def sample_fleet_renewal_gaps(process: FailureProcess, key, n_runs: int,
                              max_failures: int, n_nodes: int,
                              device="cuda"):
    """``sample_renewal_gaps`` for a process stacked over C cluster lanes:
    ``(gaps, failed_node)`` of shape ``(C, n_runs, max_failures)``.  Every
    lane transforms the same raw draws (the same ``key``) through its own
    parameters in one batched pass, so lane ``c`` holds exactly the
    histories ``sample_renewal_gaps`` draws for cluster ``c`` alone."""
    dev = resolve_device(device)
    n_clusters = fleet_size(process)
    if isinstance(process, Exponential):
        mtbf = process.mtbf_s
        mtbf = mtbf.reshape((n_clusters,) + (1,) * (4 - mtbf.ndim)
                            + mtbf.shape[1:])
        draws = prng.exponential(key, (n_runs, max_failures, n_nodes), dev) \
            * _t32(mtbf, torch.empty(0, device=dev))
        return torch.amin(draws, dim=-1), torch.argmin(draws, dim=-1)
    v = prng.uniform(key, (max_failures, n_runs, n_nodes), dev)
    ages = torch.zeros((n_clusters, n_runs, n_nodes), dtype=torch.float32,
                       device=dev)
    return _competing_risks(_fleet_residual(process, n_clusters), v, ages)


def renewal_gaps(process: FailureProcess, key, n_runs: int, n_nodes: int,
                 max_failures: int, device="cuda"):
    """Host entry point: numpy ``(gaps float64, failed_node int64)`` from
    the same sampler the engines run (on ``device``) — the float64 cast of
    the float32 gaps, so every engine sees the same histories for a key."""
    gaps, failed = sample_renewal_gaps(process, key, n_runs, max_failures,
                                       n_nodes, device)
    return (gaps.double().cpu().numpy(),
            failed.to(torch.int64).cpu().numpy())


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


# ---------------------------------------------------------------------------
# statistical helpers (host float64 numpy, the reference's)
# ---------------------------------------------------------------------------

def ks_statistic(samples, cdf, discrete: bool = False) -> float:
    """Two-sided Kolmogorov-Smirnov statistic of ``samples`` against the
    callable ``cdf``.  ``discrete=False``: the exact empirical sup over
    sorted samples; ``discrete=True`` (e.g. ``EmpiricalTrace``) compares the
    two right-continuous steps at the sampled atoms instead, which does not
    overstate the sup where samples tie."""
    x = np.sort(np.asarray(samples, np.float64).ravel())
    n = x.size
    if discrete:
        uniq, counts = np.unique(x, return_counts=True)
        cum = np.cumsum(counts) / n
        f = np.asarray(cdf(uniq), np.float64)
        return float(np.abs(cum - f).max())
    f = np.asarray(cdf(x), np.float64)
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(np.maximum(i / n - f, f - (i - 1.0) / n).max())


def ks_critical(n: int, alpha: float = 1e-3) -> float:
    """Asymptotic two-sided KS critical value at level ``alpha``:
    sqrt(-ln(alpha/2) / 2) / sqrt(n)."""
    return math.sqrt(-0.5 * math.log(alpha / 2.0)) / math.sqrt(n)


def fit_weibull(gaps, iters: int = 200, censored=None) -> tuple:
    """Maximum-likelihood Weibull fit of a gap sample: ``(k, scale_s)``.

    The profile-likelihood fixed point ``1/k = sum(t^k ln t) / sum(t^k) -
    mean(ln x_complete)`` iterated from k = 1, then ``scale^k = sum(t^k) /
    n_complete``; the sums run over complete gaps and the Type-I
    right-censored ages in ``censored`` (non-positive ages dropped).
    Degenerate inputs, as the reference: nothing to fit or a non-positive
    complete gap raises ``ValueError``; all-censored gives
    ``(1.0, sum(censored))``; one complete gap ``(1.0, sum(t))``; zero
    spread saturates at ``k = 100``.  The iteration is clamped to
    ``k in [1e-2, 1e2]`` and the k-moment taken in log-space.
    """
    x = np.asarray(gaps, np.float64).ravel()
    if np.any(x <= 0.0):
        raise ValueError("complete gaps must be positive")
    c = np.asarray([] if censored is None else censored, np.float64).ravel()
    c = c[c > 0.0]
    if x.size == 0 and c.size == 0:
        raise ValueError("need at least one positive gap or censored age")
    if x.size == 0:
        return 1.0, float(c.sum())
    t = np.concatenate([x, c])          # every observation carries t^k mass
    lt = np.log(t)
    ml = np.log(x).mean()               # only complete gaps carry ln-density

    k_lo, k_hi = 1e-2, 1e2

    def _scale(k: float) -> float:
        m = float(np.max(k * lt))
        s = m + math.log(float(np.sum(np.exp(k * lt - m)))) - math.log(x.size)
        return float(math.exp(s / k))

    if x.size == 1 and c.size == 0:
        return 1.0, float(t.sum())
    if np.ptp(lt) < 1e-12:              # zero spread: fixed point diverges
        return k_hi, _scale(k_hi)
    k = 1.0
    for _ in range(iters):
        tk = np.exp(np.clip(k * lt - np.max(k * lt), -745.0, 0.0))
        denom = np.sum(tk * lt) / np.sum(tk) - ml
        k_new = math.inf if denom <= 0.0 else 1.0 / denom
        if not np.isfinite(k_new):
            k = k_hi
            break
        k_new = min(max(k_new, k_lo), k_hi)
        if abs(k_new - k) < 1e-12:
            k = k_new
            break
        k = k_new
    return float(k), _scale(float(k))
