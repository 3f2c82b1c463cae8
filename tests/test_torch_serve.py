"""PyTorch port: the serve CLI's batching helpers against the
reference's, and the serve CLI on the CPU (``--device cpu``)."""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch.launch import batching, serve


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.mark.parametrize("n,multiple_of", [(1, 1), (3, 1), (4, 1), (5, 1),
                                           (1000, 1), (1025, 1), (3, 4),
                                           (5, 8), (2000, 8)])
def test_bucket_size_matches_reference(R, n, multiple_of):
    assert batching.bucket_size(n, multiple_of=multiple_of) == \
        R.batching.bucket_size(n, multiple_of=multiple_of)


@pytest.mark.parametrize("rows", [[1, 2, 3], np.arange(6).reshape(3, 2)])
def test_pad_rows_matches_reference(R, rows):
    for size in (3, 4, 8):
        got, want = batching.pad_rows(rows, size), R.batching.pad_rows(rows, size)
        assert type(got) is type(want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_group_and_scatter_match_reference(R):
    keys = ["b", "a", "b", "c", "a", "b"]
    groups = batching.group_indices(keys)
    assert groups == R.batching.group_indices(keys)
    results = {k: [f"{k}{j}" for j in range(len(idx))] for k, idx in groups.items()}
    assert batching.scatter(groups, results) == R.batching.scatter(groups, results)
    with pytest.raises(ValueError, match="sliced off"):
        batching.scatter(batching.group_indices(["a", "a"]), {"a": [1, 2, 3]})


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_serve_cli_pads_to_bucket_and_slices_back(capsys, arch):
    """A 3-prompt batch is served through the 4-wide bucket and reports
    exactly 3 rows of real tokens (tests/test_serve.py's check)."""
    serve.main(["--arch", arch, "--batch", "3", "--prompt-len", "4",
                "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(bucket 4)" in out
    assert "3x4 tokens" in out


def test_serve_rows_are_independent_of_padding():
    """The real rows' tokens do not depend on the padded rows: serving 3
    prompts (bucket 4) gives the first 3 rows of serving them plus a 4th."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    model = build_model(get_smoke_config("zamba2-7b"), device="cpu")
    params = model.init(0)
    prompts = np.random.default_rng(2).integers(0, 256, (4, 5))
    three = serve.serve(model, params, prompts[:3], gen=3)
    four = serve.serve(model, params, prompts, gen=3)
    assert three["bucket"] == four["bucket"] == 4
    assert three["tokens"].shape == (3, 3)
    np.testing.assert_array_equal(three["tokens"], four["tokens"][:3])


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-370m", "--gen", "2"])


def test_production_lower_is_not_ported(monkeypatch):
    """Ported since: ``--production-lower`` runs the port's dry run in a
    subprocess (``tests/test_torch_dryrun.py`` runs the dry run itself)."""
    import subprocess
    import sys

    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "zamba2-7b", "--production-lower"])
    assert exc.value.code == 0
    assert calls == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "zamba2-7b", "--shape", "decode_32k"]]
