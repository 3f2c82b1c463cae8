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
                    "-m pytest -m requires_cuda tests/test_torch_*.py)")


def load_reference():
    """Import and return the reference package's modules as a namespace."""
    import types

    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import importlib

    from repro import configs, fleet, models
    from repro.campaign import analyze, presets, runner, spec, store
    from repro.checkpoint import manager as checkpoint_manager
    from repro.core import (characterization, energy_model, failures,
                            optimize, planning, scenarios, simulator,
                            strategies, sweep, topology, trace)
    from repro.data import pipeline
    from repro.ft import controller as ft_controller, runtime as ft_runtime
    from repro.kernels import flash_attention, ops, renewal_scan, ssd_scan
    from repro.launch import batching, steps
    from repro.optim import adamw

    campaign = types.SimpleNamespace(
        analyze=analyze, presets=presets, runner=runner, spec=spec,
        store=store, cli=importlib.import_module("repro.campaign.__main__"))
    return types.SimpleNamespace(
        jax=jax, characterization=characterization,
        energy_model=energy_model, failures=failures, optimize=optimize,
        planning=planning, scenarios=scenarios, simulator=simulator,
        strategies=strategies, topology=topology, trace=trace,
        sweep=sweep, renewal_scan=renewal_scan, kernel_ops=ops,
        flash_attention=flash_attention, ssd_scan=ssd_scan, models=models,
        configs=configs, steps=steps, batching=batching, fleet=fleet,
        campaign=campaign, pipeline=pipeline, adamw=adamw,
        checkpoint=checkpoint_manager, ft_runtime=ft_runtime,
        ft_controller=ft_controller)


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
