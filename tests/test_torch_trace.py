"""PyTorch port: Paraver export and ASCII Gantt (``core/trace.py``) against
the reference's ``repro.core.trace``.

The six Table-4 scenarios are simulated by each package's event oracle,
reference and intervened, and each package renders its own run: the
``.prv`` text and the Gantt chart must be the same strings, character for
character (the event times are float64 host arithmetic in both, and the
Algorithm-1 decisions equal, so the segments agree to the microsecond the
formats print).
"""
import pytest

from torch_port_ref import load_reference

from repro_torch.core import scenarios, simulator, trace

NAMES = list(scenarios.paper_scenarios())


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def runs(ref):
    out = {}
    for name in NAMES:
        for intervene in (False, True):
            ours = simulator.simulate(scenarios.paper_scenarios()[name],
                                      intervene=intervene, device="cpu")
            theirs = ref.simulator.simulate(
                ref.scenarios.paper_scenarios()[name], intervene=intervene)
            out[name, intervene] = (ours, theirs)
    return out


@pytest.mark.parametrize("intervene", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_prv_equals_reference(ref, runs, name, intervene):
    ours, theirs = runs[name, intervene]
    text = trace.to_prv(ours)
    assert text == ref.trace.to_prv(theirs)
    assert text.startswith(f"#Paraver (repro:{name}):")
    assert len(text.splitlines()) == 1 + len(ours.segments)


@pytest.mark.parametrize("width", [40, 100])
@pytest.mark.parametrize("name", NAMES)
def test_ascii_gantt_equals_reference(ref, runs, name, width):
    for intervene in (False, True):
        ours, theirs = runs[name, intervene]
        chart = trace.ascii_gantt(ours, width=width)
        assert chart == ref.trace.ascii_gantt(theirs, width=width)
        rows = chart.splitlines()
        assert rows[1].startswith("P0*|") and len(rows[1]) == width + 5
