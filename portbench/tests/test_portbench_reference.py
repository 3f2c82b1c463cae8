"""Each plain reference against the port's own plain path (the CPU runs the
port's kernels' plain versions) at the configurations' smoke sizes, in
float32, on the weights the harness makes; mixtral also with the capacity
cut until picks are dropped."""
import pytest
import torch

from _small import CELLS, small
from portbench.lib import runner
from portbench.lib.traffic import make_pool

SEED = 2**31 + 11


def _both(cell, dims, mix):
    """The port's plain path and the reference on one batch of the mix."""
    step, weights = runner.build(cell, SEED, torch.device("cpu"), dims)
    tokens = make_pool(mix, dims["vocab"], SEED, "cpu")[0]
    got = step(weights, {"tokens": tokens})[:, :dims["vocab"]]
    want = cell.reference.forward(weights, tokens, dims)
    return got, want


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_plain_path(name):
    got, want = _both(*small(name))
    # both float32 on the CPU: the sums' order differs, nothing else
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_mixtral_reference_is_dropless(factor):
    """Under experts / top-k the port's capacity drops picks, and the
    dropless reference then departs from it; at the configuration's factor
    it does not (``test_reference_matches_the_port_plain_path``)."""
    cell, dims, mix = small("mixtral-8x22b.prefill-2x8192")
    got, want = _both(cell, dict(dims, capacity_factor=factor), mix)
    assert float((got - want).abs().max()) > 1e-3


def test_control_is_float8():
    cell, dims, mix = small("mamba2-2.7b.prefill-16x4096")
    _, weights = runner.build(cell, SEED, torch.device("cpu"), dims)
    tokens = make_pool(mix, dims["vocab"], SEED, "cpu")[0]
    fp32 = cell.reference.forward(weights, tokens, dims)
    fp8 = cell.reference.forward(weights, tokens, dims, precision="fp8")
    assert 0.01 < float((fp8 - fp32).norm() / fp32.norm()) < 2.0
    with pytest.raises(ValueError):
        cell.reference.forward(weights, tokens, dims, precision="bf16")
