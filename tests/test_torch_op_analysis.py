"""PyTorch port: the per-operation cost walker
(``repro_torch.launch.op_analysis``) against the reference's HLO walker
(``repro.launch.hlo_analysis.analyze_hlo``).

The reference's numbers come from ``jax.jit(f).lower(...).compile()
.as_text()`` on the CPU; the port's from ``analyze`` over the same
function, shapes and numpy-seeded data.  Bars, each fixed before the run
that checks it:

  * ``OpCost`` has ``HloCost``'s fields;
  * the reference's ``test_trip_count_multiplication`` program, as a
    Python loop of 7 iterations on a fake 256-rank world (in a subprocess:
    the process group is process global), gives exactly that test's flops,
    all-gather and all-reduce bytes and counts, and bytes > 0;
  * one matmul: flops and bytes equal;
  * a matmul then a pointwise chain ending in a sum: flops equal, and
    bytes equal to what the reference counts for the dot (operands and
    result) plus the sum's result (XLA's CPU backend also writes two
    intermediates of the chain, which a fused chain does not);
  * an MLP (``x@w1 -> gelu -> *g -> @w2 -> (y*y).sum()``, B 64, D 256, F
    1024, float32), forward and forward plus gradient: flops equal, bytes
    within 10 %;
  * the smallest dense config (deepseek-7b's smoke config, 2 layers,
    width 64), forward and train step: flops within 2 %, bytes within
    0.5-2x (the reference scans over stacked layers and writes each
    layer's gradient slice back into the stack, which the port's Python
    loop does not).

Each comparison prints its ratio (``-s`` shows them).  The byte rules of
the classes the dense step barely exercises (slice reads and writes,
views, creation, in-place fusions) and the memory figures are held to
hand counts on small programs, on the CPU and on ``meta``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference

from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as oa

ROOT = pathlib.Path(__file__).resolve().parents[1]

B, D, F = 64, 256, 1024


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _hlo(R, fn, *arrays):
    jax = R.jax
    return jax.jit(fn).lower(*arrays).compile().as_text()


def _ratio(what, got, want):
    r = got / want
    print(f"{what}: port {got:.0f} reference {want:.0f} ratio {r:.4f}")
    return r


# ---------------------------------------------------------------------------
# the cost record
# ---------------------------------------------------------------------------

def test_cost_fields_match_reference(R):
    from repro.launch.hlo_analysis import COLLECTIVES, HloCost

    assert ({f.name for f in dataclasses.fields(oa.OpCost)}
            == {f.name for f in dataclasses.fields(HloCost)})
    assert oa.COLLECTIVES == COLLECTIVES
    assert dryrun.COLLECTIVES is oa.COLLECTIVES
    assert dryrun.wire_bytes is oa.wire_bytes
    ours, theirs = oa.OpCost(), HloCost()
    for c in (ours, theirs):
        other = type(c)(flops=3.0, bytes=5.0)
        other.collective_bytes["all-reduce"] = 7.0
        other.collective_counts["all-gather"] = 2.0
        c.add(other, mult=4.0)
        c.add(other)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.total_collective_bytes == theirs.total_collective_bytes == 35.0


def test_trip_count_multiplication():
    """The reference test's HLO program (7 trips of an all-gather over 16
    ranks, a (16, 1024) @ (1024, 64) product and an all-reduce over 4),
    written as the collectives DTensor issues, on ``meta`` shards."""
    code = textwrap.dedent("""
        import dataclasses, json
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.op_analysis import analyze

        c10d = torch.ops._c10d_functional
        with fake_world(256):
            ranks = torch.arange(256)
            by16 = DeviceMesh("cpu", ranks.reshape(16, 16)).get_group(1)
            by4 = DeviceMesh("cpu", ranks.reshape(64, 4)).get_group(1)

            def body(x, w):
                for _ in range(7):
                    g = c10d.wait_tensor(c10d.all_gather_into_tensor(
                        x, 16, by16.group_name))
                    g = torch.cat(torch.chunk(g, 16, 0), 1)    # (16, 1024)
                    x = c10d.wait_tensor(c10d.all_reduce(
                        g @ w, "sum", by4.group_name))
                return x

            x = torch.empty((16, 64), device="meta")
            w = torch.empty((1024, 64), device="meta")
            _, cost = analyze(body, x, w)
        print(json.dumps(dataclasses.asdict(cost)))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    cost = json.loads(out.stdout.strip().splitlines()[-1])
    np.testing.assert_allclose(cost["flops"], 2 * 16 * 64 * 1024 * 7)
    np.testing.assert_allclose(cost["collective_bytes"]["all-gather"],
                               7 * (15 / 16) * 16 * 1024 * 4)
    np.testing.assert_allclose(cost["collective_bytes"]["all-reduce"],
                               7 * 2 * (3 / 4) * 16 * 64 * 4)
    assert cost["collective_counts"]["all-gather"] == 7
    assert cost["collective_counts"]["all-reduce"] == 7
    assert cost["bytes"] > 0


# ---------------------------------------------------------------------------
# against analyze_hlo on programs the CPU compiles
# ---------------------------------------------------------------------------

def _mlp_arrays():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, D)).astype(np.float32),
            (rng.standard_normal((D, F)) * 0.05).astype(np.float32),
            rng.standard_normal((B, F)).astype(np.float32),
            (rng.standard_normal((F, D)) * 0.05).astype(np.float32))


def test_matmul_matches_reference(R):
    from repro.launch.hlo_analysis import analyze_hlo

    x, w1, _, _ = _mlp_arrays()
    want = analyze_hlo(_hlo(R, lambda a, b: a @ b, x, w1))
    _, got = oa.analyze(lambda a, b: a @ b, torch.from_numpy(x),
                        torch.from_numpy(w1))
    _ratio("matmul bytes", got.bytes, want.bytes)
    assert got.flops == want.flops == 2 * B * D * F
    assert got.bytes == want.bytes == 4 * (B * D + D * F + B * F)


def test_pointwise_chain_counts_result_and_dot(R):
    from repro.launch import hlo_analysis as H

    jnp = R.jax.numpy
    x, w1, _, _ = _mlp_arrays()
    text = _hlo(R, lambda a, b: jnp.sum(jnp.exp(jnp.tanh(a @ b) * 0.5)), x, w1)
    want = H.analyze_hlo(text)
    # what the reference counts for the dot and the step's result
    comps = H._split_computations(text)
    (instrs,) = [i for i, entry in comps.values() if entry]
    symtab = {i.name: i.type_str for i in instrs}
    dots = [i for i in instrs if i.op == "dot"]
    assert len(dots) == 1
    dot_bytes = (H._shape_bytes(dots[0].type_str)
                 + H._operand_bytes(dots[0], symtab))
    result_bytes = H._shape_bytes(instrs[-1].type_str)
    _, got = oa.analyze(lambda a, b: torch.exp(torch.tanh(a @ b) * 0.5).sum(),
                        torch.from_numpy(x), torch.from_numpy(w1))
    _ratio("pointwise chain bytes against analyze_hlo's total", got.bytes,
           want.bytes)
    assert got.flops == want.flops
    assert got.bytes == dot_bytes + result_bytes == 4 * (B * D + D * F + B * F) + 4


def _jmlp(R):
    jax = R.jax

    def mlp(x, w1, g, w2):
        y = (jax.nn.gelu(x @ w1, approximate=False) * g) @ w2
        return (y * y).sum()

    return mlp


def _tmlp(x, w1, g, w2):
    y = (torch.nn.functional.gelu(x @ w1) * g) @ w2
    return (y * y).sum()


def _tmlp_grad(x, w1, g, w2):
    w1, w2 = w1.requires_grad_(True), w2.requires_grad_(True)
    return torch.autograd.grad(_tmlp(x, w1, g, w2), (w1, w2))


@pytest.mark.parametrize("mode", ["forward", "gradient"])
def test_mlp_matches_reference(R, mode):
    from repro.launch.hlo_analysis import analyze_hlo

    arrays = _mlp_arrays()
    jfn = _jmlp(R)
    if mode == "gradient":
        jfn = R.jax.grad(jfn, argnums=(1, 3))
    want = analyze_hlo(_hlo(R, jfn, *arrays))
    tfn = _tmlp if mode == "forward" else _tmlp_grad
    _, got = oa.analyze(tfn, *(torch.from_numpy(a) for a in arrays))
    r = _ratio(f"mlp {mode} bytes", got.bytes, want.bytes)
    assert got.flops == want.flops
    assert 0.9 <= r <= 1.1


def _dense_pair(R, num_layers=2):
    from repro_torch import configs as tconfigs
    from repro_torch.models import build_model, params_from_reference

    jax = R.jax
    arch = "deepseek-7b"
    jcfg = R.configs.get_smoke_config(arch, num_layers=num_layers)
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke_config(arch, num_layers=num_layers)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, 256, (4, 17)).astype(np.int32)
    jb = {"tokens": jax.numpy.asarray(toks[:, :-1]),
          "labels": jax.numpy.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    return jm, jp, jb, tm, tp, tb


@pytest.mark.parametrize("mode", ["forward", "train_step"])
def test_dense_step_matches_reference(R, mode):
    from repro.launch.hlo_analysis import analyze_hlo

    from repro_torch.launch import steps as tsteps
    from repro_torch.optim import adamw as tadamw

    jm, jp, jb, tm, tp, tb = _dense_pair(R)
    if mode == "forward":
        want = analyze_hlo(_hlo(R, jm.forward, jp, {"tokens": jb["tokens"]}))
        _, got = oa.analyze(tm.forward, tp, {"tokens": tb["tokens"]})
    else:
        jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=1e-3))
        to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=1e-3))
        want = analyze_hlo(_hlo(R, R.steps.make_train_step(jm, jo), jp,
                                jo.init(jp), jb))
        _, got = oa.analyze(tsteps.make_train_step(tm, to), tp, to.init(tp), tb)
    _ratio(f"dense {mode} flops", got.flops, want.flops)
    r = _ratio(f"dense {mode} bytes", got.bytes, want.bytes)
    assert abs(got.flops / want.flops - 1.0) <= 0.02
    assert 0.5 <= r <= 2.0


# ---------------------------------------------------------------------------
# the byte rules and the memory figures, by hand
# ---------------------------------------------------------------------------

N = 1024                                  # float32 elements: 4 KiB a tensor


def _fused(x):
    return torch.exp(x * 2.0).sum()


def _slice_read(x):
    return torch.index_select(x.view(32, 32), 0, torch.arange(0, 32, 4))


def _slice_write(x):
    acc = torch.zeros((64, 32))
    return acc.index_add_(0, torch.arange(0, 64, 2), (x * 3.0).view(32, 32))


def _copy_into_view(x):
    out = torch.empty(2 * N)
    out[:N].copy_(x.exp())
    return out


def _view_and_clone(x):
    return x.view(32, 32).t().clone()


def _in_place_chain(x):
    y = x * 2.0
    y.add_(1.0)
    return y @ torch.ones((N, 8))


@pytest.mark.parametrize("fn,want", [
    # the chain and its sum fuse: the (fused) sum's 4-byte result only
    (_fused, 4),
    # index_select: 2 x its 8 x 32 result
    (_slice_read, 2 * 8 * 32 * 4),
    # the scaled source is read by the scatter (its fusion writes 4 KiB),
    # index_add_: 2 x the 4 KiB update
    (_slice_write, 4 * N + 2 * 4 * N),
    # exp's result is read by the slice write; copy_: 2 x its 4 KiB
    (_copy_into_view, 4 * N + 2 * 4 * N),
    # views cost nothing; the clone is a fused output
    (_view_and_clone, 4 * N),
    # x * 2 and the in-place add are one fusion, read by the product
    (_in_place_chain, 4 * N + (4 * N + 4 * N * 8 + 4 * 8)),
], ids=["fused", "slice_read", "slice_write", "copy_into_view", "views",
        "in_place_chain"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_byte_rules(fn, want, device):
    x = torch.linspace(-1.0, 1.0, N)
    if device == "meta":
        x = x.to("meta")
        with torch.device("meta"):
            _, cost = oa.analyze(fn, x)
    else:
        _, cost = oa.analyze(fn, x)
    assert cost.bytes == want


def test_peak_and_temp_bytes_are_exact():
    """Argument 4 KiB; two 4 KiB temporaries alive together; a 4-byte
    output."""
    def fn(x):
        y = x * 2.0
        z = y.exp()
        return z.sum()

    x = torch.ones(N)
    trace = oa.OpTrace("cpu")
    trace.arguments((x,))
    with trace:
        out = fn(x)
    trace.outputs(out)
    assert trace.peak_bytes == 3 * 4 * N + 4
    assert trace.temp_bytes == 2 * 4 * N
    assert trace.cost.bytes == 4
    assert trace.live_bytes == 4 * N + 4           # temporaries freed


def test_walker_holds_no_tensor():
    """The walker keeps no tensor alive: temporaries die with the step,
    and what the step returns dies with its last reference."""
    import gc
    import weakref

    seen = []

    def fn(x):
        y = x + 1.0
        seen.append(weakref.ref(y))
        return (y * 2.0).sum()

    x = torch.ones(N)
    trace = oa.OpTrace("cpu")
    trace.arguments((x,))
    with trace:
        out = fn(x)
    trace.outputs(out)
    gc.collect()
    assert seen[0]() is None
    del out
    gc.collect()
    assert trace.live_bytes == 4 * N


def test_other_devices_and_dtensors_are_not_counted():
    """A walker on ``meta`` counts nothing of a CPU step."""
    x = torch.ones((8, 8))
    trace = oa.OpTrace("meta")
    with trace:
        (x @ x).exp()
    assert trace.cost.flops == 0 and trace.cost.bytes == 0
    assert trace.peak_bytes == 0
