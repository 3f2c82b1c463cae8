"""On the card (``-m requires_cuda``): one short run of the mixtral cell at
its full size is correct, the same run with a greedy answer altered where
it is produced is not, and at that size the float8 control breaks a limit
that the port keeps."""
import time

import pytest
import torch

from portbench import control
from portbench.lib import faults, runner, spec

CELL = "mixtral-8x22b.prefill-2x8192"


def _run(seed):
    # long enough for the cell's four checked prefills
    return runner.run(spec.cell(CELL), seed, 5.0, False, started=time.time())


@pytest.mark.requires_cuda
def test_full_size_run_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _run(2**31 + 101)["correct"] is True
    from repro_torch.launch import steps

    real = steps.make_prefill_step
    vocab = spec.cell(CELL).config_doc["vocab_size"]
    monkeypatch.setattr(steps, "make_prefill_step", lambda model: faults.wrap(
        real(model), "answer", vocab))
    assert _run(2**31 + 102)["correct"] is False


@pytest.mark.requires_cuda
def test_control_breaks_a_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell(CELL)
    found = control.readings(cell, [2**31 + 103], [2**31 + 103])
    limits = {n: v for n, v in cell.limits["limits"].items() if v is not None}
    assert all(found["program"][n][0] <= v for n, v in limits.items())
    assert any(found["control"][n][0] > v for n, v in limits.items())
