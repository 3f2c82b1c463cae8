"""Shared helper of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX reference (``repro``) is imported lazily, inside fixtures, through
``load_reference()``: it pins JAX to the CPU and, before the first
``import repro``, aliases ``jax.experimental.enable_x64`` to
``jax.enable_x64`` — the installed jax moved the context manager, and the
reference's modules still import it from the old place.  The alias is
process-global: once a port test has run, the reference imports in that
process.  ``requires_cuda`` marks the tests that need a card; whether there
is one is decided when the test runs, never at import.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

requires_cuda = pytest.mark.requires_cuda


def skip_without_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: PYTHONPATH=src python "
                    "-m pytest -m requires_cuda tests/test_torch_renewal_scan.py)")


def load_reference():
    """Import and return the reference package's modules as a namespace."""
    import types

    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.core import (characterization, energy_model, failures,
                            optimize, planning, scenarios, strategies, sweep)
    from repro.kernels import renewal_scan

    return types.SimpleNamespace(
        jax=jax, characterization=characterization,
        energy_model=energy_model, failures=failures, optimize=optimize,
        planning=planning, scenarios=scenarios, strategies=strategies,
        sweep=sweep, renewal_scan=renewal_scan)


def to_np(x):
    """numpy view of a jax array, torch tensor or scalar."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel_close(actual, expected, rtol, what=""):
    a = np.asarray(to_np(actual), np.float64)
    e = np.asarray(to_np(expected), np.float64)
    assert a.shape == e.shape, f"{what}: shape {a.shape} != {e.shape}"
    denom = np.maximum(np.abs(e), 1e-30)
    err = np.abs(a - e) / denom
    assert np.all(err <= rtol), f"{what}: max rel err {err.max():.3e} > {rtol}"
