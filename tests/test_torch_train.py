"""PyTorch port: the training path against the JAX reference — the counter
PRNG's ``fold_in``/``randint``, ``SyntheticLM``, AdamW and SGD, the dense
family's forward and decode, ``make_train_step`` (microbatches, both
``grad_accum`` modes), the ssm and hybrid families under autograd, and the
kernels' refusal of grad mode on the card.

The reference's ``init(PRNGKey(0))`` weights are carried into the port with
``params_from_reference``; inputs are seeded numpy arrays handed to both.
Bars: PRNG draws and batches bit-equal; the optimizers within 1e-6 of
each leaf's largest magnitude, ``count`` exact (unclipped: bit-equal; with
clipping the global norm can differ by an ulp, since XLA and torch sum a
leaf in different orders, and a moment that cancels to ~5e-6 keeps that
ulp as its absolute error: 3.7e-9 observed); dense forward logits within
1e-5 (float32, logits of order 1); decode against the forward at
``tests/test_models.py``'s bar (atol 5e-3, rtol 1e-3); train-step losses
within 1e-5 relative at each of three steps.  Parameters after each of
three AdamW steps at learning rate 1e-3 are held within 1e-5 absolute,
except where the first gradient is float32 noise (0 < |g| <= 1e-6): Adam
divides each gradient by its own root mean square, so such an element
moves by up to ~lr either way, and it is held to 2 * steps * lr
(``torch_port_ref.assert_params_close``; ROADMAP.md Queue 3 item 14).
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import (assert_params_close, first_step_grads,
                            load_reference, requires_cuda, skip_without_cuda)

from repro_torch import configs as tconfigs
from repro_torch._tree import items, leaves
from repro_torch.core import prng
from repro_torch.data.pipeline import SyntheticLM, make_pipeline
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, layers, params_from_reference
from repro_torch.optim import adamw as tadamw

ARCH = "deepseek-7b"
LR = 1e-3
B, S = 4, 16
TOL_LOGITS = 1e-5
TOL_LOSS = 1e-5
TOL_PARAMS = 1e-5


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _np(x):
    return x.detach().cpu().numpy()


def _batches(n, seed=1, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def _jbatch(R, toks):
    jnp = R.jax.numpy
    return {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}


def _tbatch(toks):
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def _carry(R, arch, **over):
    """Reference model and params; the port's model and the same params."""
    jax = R.jax
    jcfg = R.configs.get_smoke_config(arch, **over)
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke_config(arch, **over)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# the counter PRNG and the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (3, 42), (12345, 7),
                                       (1, 2**31 + 5), (2**32 + 9, 99999)])
def test_fold_in_bit_equal_to_jax(R, seed, data):
    jax = R.jax
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data), want)


@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 102400), (0, 100), (0, 7),
                                   (0, 65536), (0, 65537), (-7, 300),
                                   (0, 2**31 - 1), (5, 5)])
def test_randint_bit_equal_to_jax(R, lo, hi):
    jax = R.jax
    for seed, step in ((0, 0), (3, 11), (77, 123456)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        want = np.asarray(jax.random.randint(key, (3, 37), lo, hi,
                                             dtype=jax.numpy.int32))
        got = prng.randint(prng.fold_in(prng.PRNGKey(seed), step), (3, 37),
                           lo, hi, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("vocab", [256, 102400])
def test_synthetic_lm_bit_equal_to_reference(R, vocab):
    for seed in (0, 5):
        ref = R.pipeline.SyntheticLM(vocab_size=vocab, seq_len=16,
                                     global_batch=3, seed=seed)
        port = SyntheticLM(vocab_size=vocab, seq_len=16, global_batch=3,
                           seed=seed, device="cpu")
        for step in (0, 1, 9, 1000):
            want, got = ref.host_batch_at(step), port.host_batch_at(step)
            assert set(got) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    pipe = make_pipeline(tconfigs.get_smoke_config(ARCH),
                         tconfigs.SHAPES["train_4k"], device="cpu")
    assert (pipe.seq_len, pipe.global_batch, pipe.vocab_size) == (4096, 256, 256)


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(vocab_size=10, seq_len=4, global_batch=2).batch_at(0)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_pair(R, kind):
    if kind == "sgd":
        return R.adamw.sgd(lr=1e-2), tadamw.sgd(lr=1e-2)
    clip = 1.0 if kind == "adamw-clip" else None
    return (R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=1e-2,
                                              grad_clip_norm=clip)),
            tadamw.adamw(tadamw.AdamWConfig(learning_rate=1e-2,
                                            grad_clip_norm=clip)))


@pytest.mark.parametrize("kind", ["adamw-clip", "adamw-noclip", "sgd"])
def test_optimizer_matches_reference(R, kind):
    jax, jnp = R.jax, R.jax.numpy
    rng = np.random.default_rng(0)
    params = {"blocks": {"w": rng.standard_normal((2, 5, 3)).astype(np.float32),
                         "a": rng.standard_normal((2, 4)).astype(np.float32)},
              "embed": rng.standard_normal((6, 3)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3
                                     ).astype(np.float32), params)
             for _ in range(4)]
    jo, to = _opt_pair(R, kind)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = jax.tree.map(torch.from_numpy, g)
        before = [t.clone() for t in leaves((tg, ts, tp))]
        new_p, new_s = to.update(tg, ts, tp)
        # functional: the arguments are untouched
        for x, y in zip(before, leaves((tg, ts, tp))):
            assert torch.equal(x, y)
        tp, ts = new_p, new_s
    assert int(ts["count"]) == int(js["count"]) == len(grads)
    assert ts["count"].dtype == torch.int32
    for tree_j, tree_t in ((jp, tp), (js["mu"], ts["mu"]), (js["nu"], ts["nu"])):
        for (path, t), j in zip(items(tree_t), jax.tree.leaves(tree_j)):
            j = np.asarray(j)
            assert t.dtype == getattr(torch, j.dtype.name), path
            err = np.abs(_np(t) - j).max() / max(np.abs(j).max(), 1e-30)
            assert err <= 1e-6, (path, err)


def test_adamw_moments_are_float32_for_bf16_params():
    opt = tadamw.adamw()
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["mu"]["w"].dtype == torch.float32
    new_p, new_s = opt.update({"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16)},
                              state, params)
    assert new_p["w"].dtype == torch.bfloat16
    assert new_s["nu"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the dense family
# ---------------------------------------------------------------------------

def test_dense_forward_matches_reference(R):
    jax = R.jax
    jm, jp, tm, tp = _carry(R, ARCH)
    toks = _batches(1)[0][:, :-1]
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jax.numpy.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_LOGITS,
                               rtol=TOL_LOGITS)


def test_dense_decode_matches_forward_and_reference(R):
    jax, jnp = R.jax, R.jax.numpy
    jm, jp, tm, tp = _carry(R, ARCH)
    toks = _batches(1)[0][:, :-1]
    logits, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    cache = tm.init_cache(B, S)
    jcache = jm.init_cache(B, S)
    with torch.inference_mode():
        for t in range(S):
            step, cache = tm.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
            jstep, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(_np(step[:, 0]), _np(logits[:, t]),
                                       atol=5e-3, rtol=1e-3)
            np.testing.assert_allclose(_np(step), np.asarray(jstep),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_micro,accum", [(1, "inside"), (1, "outside"),
                                           (2, "inside"), (2, "outside")])
def test_train_step_matches_reference(R, n_micro, accum):
    """Three steps: losses within 1e-5 relative; parameters within 1e-5
    where the port's first gradient is clear of float32 noise, the noise
    elements within 2 * steps * lr (under 1 % of each leaf).  Adam's first
    step moves a noise element by an arbitrary fraction of lr (ROADMAP.md
    Queue 3 item 14: ``blocks/attn/wo``, 1 of 8,192 elements, 1.8e-5 apart
    after the first step on one CPU, within the bar on another)."""
    jax = R.jax
    jm, jp, tm, tp = _carry(R, ARCH, train_microbatches=n_micro)
    jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=LR))
    to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=LR))
    jst, tst = jo.init(jp), to.init(tp)
    jstep = jax.jit(R.steps.make_train_step(jm, jo, grad_accum=accum))
    tstep = tsteps.make_train_step(tm, to, grad_accum=accum)
    batches = _batches(3)
    g1 = first_step_grads(tm, tp, _tbatch(batches[0]), grad_accum=accum)
    for step, toks in enumerate(batches, 1):
        jp, jst, jmet = jstep(jp, jst, _jbatch(R, toks))
        tp, tst, tmet = tstep(tp, tst, _tbatch(toks))
        assert set(tmet) == set(jmet) == {"loss", "aux_loss", "total_loss"}
        for k in jmet:
            want = float(jmet[k])
            assert abs(float(tmet[k]) - want) <= TOL_LOSS * max(abs(want), 1e-30), k
        assert_params_close(items(tp), jax.tree.leaves(jp), g1, atol=TOL_PARAMS,
                            steps=step, lr=LR)
    assert int(tst["count"]) == int(jst["count"]) == 3


def test_train_step_leaves_its_inputs_unchanged():
    cfg = tconfigs.get_smoke_config(ARCH, train_microbatches=2)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = tadamw.adamw()
    state = opt.init(params)
    batch = _tbatch(_batches(1)[0])
    before = [t.clone() for t in leaves((params, state, batch))]
    new_p, new_s, _ = tsteps.make_train_step(model, opt)(params, state, batch)
    for x, y in zip(before, leaves((params, state, batch))):
        assert torch.equal(x, y)
    assert all(not t.requires_grad for t in leaves((params, new_p, new_s)))
    assert not any(a.data_ptr() == b.data_ptr()
                   for a, b in zip(leaves(params), leaves(new_p)))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_and_hybrid_take_a_train_step(R, arch):
    """The ssm and hybrid families differentiate through their plain paths;
    the loss of each of two steps equals the reference's (1e-5 relative)."""
    jax = R.jax
    jm, jp, tm, tp = _carry(R, arch)
    jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=LR))
    to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=LR))
    jst, tst = jo.init(jp), to.init(tp)
    jstep = jax.jit(R.steps.make_train_step(jm, jo))
    tstep = tsteps.make_train_step(tm, to)
    for toks in _batches(2, seed=3):
        jp, jst, jmet = jstep(jp, jst, _jbatch(R, toks))
        tp, tst, tmet = tstep(tp, tst, _tbatch(toks))
        want = float(jmet["total_loss"])
        assert abs(float(tmet["total_loss"]) - want) <= TOL_LOSS * want


def test_remat_recomputes_the_same_gradients():
    """``remat="full"`` (per-layer checkpointing) changes memory, not
    values: the same step with and without it is bit-equal."""
    out = []
    for remat in ("none", "full"):
        cfg = tconfigs.get_smoke_config(ARCH, remat=remat)
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        opt = tadamw.adamw()
        new_p, _, met = tsteps.make_train_step(model, opt)(
            params, opt.init(params), _tbatch(_batches(1)[0]))
        out.append((new_p, met["total_loss"]))
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(leaves(out[0][0]), leaves(out[1][0])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        build_model(tconfigs.get_smoke_config(ARCH, remat="some"), "cpu").forward(
            out[0][0], _tbatch(_batches(1)[0]))


def test_split_microbatches_matches_reference(R):
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "mrope_positions": rng.integers(0, 9, (3, 4, 6)).astype(np.int32)}
    want = R.steps._split_microbatches(
        {k: R.jax.numpy.asarray(v) for k, v in batch.items()}, 2)
    got = tsteps._split_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    for k in batch:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert tsteps.AUX_LOSS_WEIGHT == R.steps.AUX_LOSS_WEIGHT


def test_embed_backward_sums_repeated_tokens_in_a_fixed_order():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((50, 8), dtype=torch.float64, generator=gen)
    toks = torch.randint(0, 50, (3, 40), generator=gen)
    toks[0, :25] = 7                       # one token 25 times
    g = torch.randn((3, 40, 8), dtype=torch.float64, generator=gen)
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        (layers.embed(t, toks, torch.float64) * g).sum().backward()
        grads.append(t.grad)
    want = torch.zeros_like(table).index_add_(0, toks.reshape(-1), g.reshape(-1, 8))
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], want, atol=1e-12, rtol=1e-12)
    bf = table.to(torch.bfloat16).requires_grad_(True)
    layers.embed(bf, toks, torch.float32).sum().backward()
    assert bf.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the kernels refuse grad mode on the card (the gradient is never dropped)
# ---------------------------------------------------------------------------

def test_refuse_grad_raises_only_for_grad_operands():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_attention", torch.ones(3), x)
    _build.refuse_grad("flash_attention", torch.ones(3))
    with torch.no_grad():
        _build.refuse_grad("flash_attention", x)
    with torch.inference_mode():
        _build.refuse_grad("ssd_scan", x)


def test_plain_kernel_versions_stay_differentiable_on_cpu():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 8, 2, 16), generator=gen, requires_grad=True)
    k, v = torch.randn((1, 8, 2, 16), generator=gen), torch.randn((1, 8, 2, 16), generator=gen)
    kops.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
    x = torch.randn((1, 8, 2, 16), generator=gen, requires_grad=True)
    dt = torch.rand((1, 8, 2), generator=gen)
    a = -torch.rand((2,), generator=gen)
    bm, cm = torch.randn((1, 8, 1, 16), generator=gen), torch.randn((1, 8, 1, 16), generator=gen)
    y, _ = kops.ssd_scan(x, dt, a, bm, cm, chunk=8)
    y.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


@requires_cuda
def test_kernel_calls_under_grad_raise_on_card():
    skip_without_cuda()
    dev = torch.device("cuda")
    q = torch.randn((1, 64, 2, 64), device=dev, requires_grad=True)
    k, v = torch.randn((1, 64, 2, 64), device=dev), torch.randn((1, 64, 2, 64), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.flash_attention(q, k, v)
    with torch.no_grad():
        assert kops.flash_attention(q, k, v).shape == q.shape
    x = torch.randn((1, 64, 2, 64), device=dev, requires_grad=True)
    dt = torch.rand((1, 64, 2), device=dev)
    a = -torch.rand((2,), device=dev)
    bm, cm = torch.randn((1, 64, 1, 64), device=dev), torch.randn((1, 64, 1, 64), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.ssd_scan(x, dt, a, bm, cm, chunk=64)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), use_flash_kernel=True)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = tadamw.adamw()
    toks = _tbatch(_batches(1)[0])
    with pytest.raises(RuntimeError, match="no backward"):
        tsteps.make_train_step(model, opt)(
            params, opt.init(params), {k_: t.cuda() for k_, t in toks.items()})


@requires_cuda
def test_two_identical_steps_are_bit_equal_on_card():
    skip_without_cuda()
    cfg = tconfigs.get_smoke_config(ARCH, train_microbatches=2)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = tadamw.adamw()
    state = opt.init(params)
    pipe = SyntheticLM(cfg.vocab_size, 64, 8, device="cuda")
    step = tsteps.make_train_step(model, opt)
    a = step(params, state, pipe.batch_at(3))
    b = step(params, state, pipe.batch_at(3))
    assert torch.equal(a[2]["total_loss"], b[2]["total_loss"])
    for x, y in zip(leaves(a[:2]), leaves(b[:2])):
        assert torch.equal(x, y)
