"""PyTorch port: gradient compression (``parallel/compression.py``) against
the JAX reference.

The same seeded numpy gradients go to both.  int8: codes and scale
bit-equal, and so the decompressed gradient.  Top-k: where magnitudes
tie at the cut ``torch.topk`` may keep other entries than XLA's
``top_k``, so the kept indices are not compared; the decompressed tensor
and the residual are (equal, on gradients whose magnitudes are distinct,
and sent + residual = compressed input bit for bit on every input).
``wrap_optimizer`` over AdamW and SGD: parameters and residuals after
several updates within 1e-6 of each leaf's largest magnitude, as
``tests/test_torch_train.py`` holds the optimizers.
"""
import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch._tree import items, leaves, tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import compression as tc


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.fixture(scope="module")
def jc(R):
    from repro.parallel import compression
    return compression


def _np(x):
    return x.detach().cpu().numpy()


def _grad(shape, seed, zeros=0.0):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zeros:
        g[np.random.default_rng(seed + 1).random(shape) < zeros] = 0.0
    return g


@pytest.mark.parametrize("shape", [(128,), (7, 33), (3, 4, 5)])
def test_int8_matches_reference(R, jc, shape):
    g = _grad(shape, 1) * 3
    jq, js = jc.int8_compress(R.jax.numpy.asarray(g))
    q, s = tc.int8_compress(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert float(s) == float(js)
    out = tc.int8_decompress(q, s)
    np.testing.assert_array_equal(_np(out), np.asarray(jc.int8_decompress(jq, js)))
    # tests/test_ft.py's bound: within half a step of the scale
    assert float((out - torch.from_numpy(g)).abs().max()) <= float(s) / 2 + 1e-6


def test_int8_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = tc.int8_compress(g)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


@requires_cuda
def test_int8_on_card_equals_cpu():
    """The scale's division by 127 gives the CPU's bits on the card (a
    Python-number divisor is a reciprocal multiply there, which rounds
    otherwise for some scales)."""
    skip_without_cuda()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2000):
        g = torch.randn(64, generator=gen) * float(torch.rand(1, generator=gen)) * 100
        q, s = tc.int8_compress(g)
        qc, sc = tc.int8_compress(g.cuda())
        assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)


@pytest.mark.parametrize("ratio", [0.25, 0.05, 1e-9])
def test_topk_matches_reference(R, jc, ratio):
    g = _grad((64, 9), 2)
    jk, ji, jshape = jc.topk_compress(R.jax.numpy.asarray(g), ratio)
    k, i, shape = tc.topk_compress(torch.from_numpy(g), ratio)
    assert shape == tuple(jshape) and k.shape == jk.shape
    want = np.asarray(jc.topk_decompress(jk, ji, jshape))
    got = tc.topk_decompress(k, i, shape)
    np.testing.assert_array_equal(_np(got), want)
    assert int((got != 0).sum()) == max(1, int(g.size * ratio))


def test_topk_roundtrip_preserves_largest():
    """tests/test_ft.py's test_topk_roundtrip_preserves_largest."""
    g = torch.from_numpy(_grad((64,), 0))
    out = tc.topk_decompress(*tc.topk_compress(g, 0.25))
    top = np.argsort(-np.abs(_np(g)))[:16]
    np.testing.assert_allclose(_np(out)[top], _np(g)[top], rtol=1e-6)
    assert int((out != 0).sum()) <= 16


@pytest.mark.parametrize("method", ["topk", "int8", "none"])
def test_compress_tree_matches_reference(R, jc, method):
    """Error feedback on a tree with exact zeros (ties at the top-k cut):
    sent + residual is the compressed input bit for bit; with distinct
    magnitudes the sent gradients and the residuals equal the reference's."""
    jax = R.jax
    cfg = tc.CompressionConfig(method=method, topk_ratio=0.1)
    jcfg = jc.CompressionConfig(method=method, topk_ratio=0.1)
    grads = {"a": {"w": _grad((6, 10), 3)}, "b": _grad((40,), 4)}
    res = {"a": {"w": _grad((6, 10), 5) * 0.01}, "b": _grad((40,), 6) * 0.01}
    jsent, jres = jc._compress_tree(grads, res, jcfg)
    t = lambda tree: tree_map(torch.from_numpy, tree)
    sent, new_res = tc._compress_tree(t(grads), t(res), cfg)
    for (path, s), r, j_s, j_r, g, r0 in zip(
            items(sent), leaves(new_res), jax.tree.leaves(jsent),
            jax.tree.leaves(jres), leaves(grads), leaves(res)):
        assert s.dtype == r.dtype == torch.float32
        np.testing.assert_array_equal(_np(s), np.asarray(j_s), err_msg=str(path))
        np.testing.assert_array_equal(_np(r), np.asarray(j_r), err_msg=str(path))
        np.testing.assert_array_equal(_np(s + r), g + r0)
    zeros = {"w": _grad((200,), 7, zeros=0.9)}
    sent, new_res = tc._compress_tree(t(zeros), tree_map(torch.zeros_like, t(zeros)),
                                      cfg)
    assert torch.equal(sent["w"] + new_res["w"], torch.from_numpy(zeros["w"]))


@pytest.mark.parametrize("method", ["topk", "int8"])
@pytest.mark.parametrize("base", ["adamw", "sgd"])
def test_wrap_optimizer_matches_reference(R, jc, method, base):
    jax, jnp = R.jax, R.jax.numpy
    if base == "adamw":
        jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=1e-2))
        to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=1e-2))
    else:
        jo, to = R.adamw.sgd(lr=1e-2), tadamw.sgd(lr=1e-2)
    cfg = dict(method=method, topk_ratio=0.2)
    jo = jc.wrap_optimizer(jo, jc.CompressionConfig(**cfg))
    to = tc.wrap_optimizer(to, tc.CompressionConfig(**cfg))
    params = {"blocks": {"w": _grad((2, 5, 3), 8)}, "embed": _grad((6, 3), 9)}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts) == {"base", "residual"}
    assert all(r.dtype == torch.float32 and not r.any() for r in leaves(ts["residual"]))
    for step in range(4):
        g = {"blocks": {"w": _grad((2, 5, 3), 20 + step) * 3},
             "embed": _grad((6, 3), 30 + step)}
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(tree_map(torch.from_numpy, g), ts, tp)
    for tree_t, tree_j in ((tp, jp), (ts["residual"], js["residual"])):
        for (path, t), j in zip(items(tree_t), jax.tree.leaves(tree_j)):
            j = np.asarray(j)
            err = np.abs(_np(t) - j).max() / max(np.abs(j).max(), 1e-30)
            assert err <= 1e-6, (path, err)


def test_error_feedback_converges():
    """tests/test_ft.py's test_error_feedback_converges on the port."""
    target = torch.from_numpy(_grad((32,), 2))
    params = {"w": torch.zeros(32)}
    opt = tc.wrap_optimizer(tadamw.sgd(lr=0.1, momentum=0.0),
                            tc.CompressionConfig(method="topk", topk_ratio=0.125))
    state = opt.init(params)
    for _ in range(400):
        params, state = opt.update({"w": params["w"] - target}, state, params)
    np.testing.assert_allclose(_np(params["w"]), _np(target), atol=0.05)


def test_compression_ratio_matches_reference(jc):
    for method in ("topk", "int8", "none"):
        for ratio in (0.05, 0.3):
            assert tc.compression_ratio(tc.CompressionConfig(method, ratio)) == \
                jc.compression_ratio(jc.CompressionConfig(method, ratio))
