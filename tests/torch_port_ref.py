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


# ---------------------------------------------------------------------------
# parameters after AdamW steps, port against reference
# ---------------------------------------------------------------------------

NOISE = 1e-6          # first-step gradients at or below it are float32 noise
NOISE_SHARE = 0.01    # at most this share of a leaf may be noise elements


def first_step_grads(model, params, batch, *, grad_accum: str = "inside"):
    """The gradient that the port's ``make_train_step`` takes of its loss on
    ``batch`` at ``params`` (microbatches and ``grad_accum`` as configured),
    one CPU tensor per leaf in ``leaves`` order; the parameters are left
    as they were."""
    from repro_torch._tree import leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import Optimizer

    seen = []

    def record(grads, state, p):
        seen.append([g.detach().cpu() for g in leaves(grads)])
        return p, state

    make_train_step(model, Optimizer(init=lambda p: None, update=record),
                    grad_accum=grad_accum)(params, None, batch)
    return seen[0]


def assert_params_close(port, ref, grads, *, atol: float, steps: int,
                        lr: float) -> None:
    """Parameters after ``steps`` AdamW steps of the port against the
    reference's.  ``port`` is ``items(params)`` of the port, ``ref`` the
    reference's leaves in the same order, ``grads`` ``first_step_grads`` of
    the same start.

    Adam's first update of an element is lr * g / (|g| + eps): where the
    first gradient is float32 noise (0 < |g| <= NOISE) the two frameworks
    move it by arbitrary fractions of lr, either way (ROADMAP.md Queue 3
    item 14).  Those elements are held to 2 * steps * lr, Adam's largest
    step each way; every other element, exact zeros included, to ``atol``.
    Fewer than NOISE_SHARE of a leaf's elements may be noise elements, so
    the mask cannot hide a real divergence."""
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) == len(grads)
    for (path, t), j, g in zip(port, ref, grads):
        a = np.asarray(to_np(t), np.float64)
        b = np.asarray(to_np(j), np.float64)
        assert a.shape == b.shape == tuple(g.shape), str(path)
        gap = np.abs(a - b)
        gn = np.abs(to_np(g))
        noise = (gn > 0) & (gn <= NOISE)
        assert noise.mean() < NOISE_SHARE, \
            f"{path}: {noise.mean():.2%} of its first gradient is noise"
        held = gap[~noise]
        if held.size:
            k = int(np.argmax(held))
            assert held[k] <= atol, \
                f"{path}: {held[k]:.3e} > {atol} (|g1| {gn[~noise][k]:.3e})"
        if noise.any():
            assert gap[noise].max() <= 2 * steps * lr, \
                f"{path}: a noise element {gap[noise].max():.3e} > 2 * {steps} * {lr}"
