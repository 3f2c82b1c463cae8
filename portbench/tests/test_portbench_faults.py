"""The comparison catches what it must: a run with a fault planted under
the timed path (``lib/faults.py``) comes out not correct, and the float8
control departs from the reference.  At the configurations' smoke sizes on
the CPU; the readings at the cells' own sizes, which set the limits, are
``control.py``'s on the card (``test_portbench_card.py`` holds one cell's
control against its limits there)."""
import time

import pytest

from _small import CELLS, small
from portbench import control
from portbench.lib import faults, runner

SEED = 2**32 + 3


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    from repro_torch.launch import steps

    cell, dims, mix = small(name)
    real = steps.make_prefill_step
    monkeypatch.setattr(steps, "make_prefill_step", lambda model: faults.wrap(
        real(model), fault, dims["vocab"]))
    result = runner.run(cell, SEED, 0.3, False, started=time.time(),
                        device="cpu", dims=dims, mix=mix)
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_departs_from_the_reference(name):
    """The float8 control in the program's place, at the smoke sizes in
    float32: on every seed it reads a thousand times the port's plain
    path or more.  Its readings against the limits are taken at the cell's
    own size on the card (``control.py``, ``test_portbench_card.py``)."""
    cell, dims, mix = small(name)
    seeds = [SEED, SEED + 1, SEED + 2]
    found = control.readings(cell, seeds, seeds, device="cpu", mix=mix, dims=dims)
    assert min(found["control"]["logit_rel_err"]) > 0.01
    assert min(found["control"]["logit_rel_err"]) >= \
        1000 * max(found["program"]["logit_rel_err"])
