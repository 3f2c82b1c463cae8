"""PyTorch port: the LM serving path (configs, layers, the Mamba2 and
Zamba2 models, prefill and decode) against the JAX reference.

The reference's ``init(PRNGKey(0))`` weights are carried into the port with
``params_from_reference``; both then see the same tokens (numpy, seeded).
Tolerances: forward and decode logits against the reference atol/rtol 1e-4
(float32 smoke configs, logits of order 1: the two frameworks sum matmuls
and cumulative decays in other orders, ~1e-5 observed); the port's decode
against its own forward at ``tests/test_models.py``'s
``test_decode_matches_forward`` bar (atol 5e-3, rtol 1e-3); single layers
1e-5.  With ``use_flash_kernel`` the reference runs its Pallas kernels in
interpret mode and the port runs their plain versions (this is the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch.launch.steps import cross_entropy, make_prefill_step
from repro_torch.models import build_model, layers, mlp, model_spec
from repro_torch.models import params_from_reference

B, S = 2, 32
MODEL_ARCHS = ("zamba2-7b", "mamba2-370m")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_models(R, tokens):
    """Per (arch, flash): the reference model, its weights as numpy, its
    jitted forward logits on ``tokens``, and the port's model and weights.
    Built once: the zamba2 kernel path runs Pallas in interpret mode."""
    jax, jnp = R.jax, R.jax.numpy
    out = {}
    for arch in MODEL_ARCHS:
        for flash in (False, True):
            jcfg = R.configs.get_smoke_config(arch, use_flash_kernel=flash)
            jm = R.models.build_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            logits, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
            tcfg = tconfigs.get_smoke_config(arch, use_flash_kernel=flash)
            tree = jax.tree.map(np.asarray, jp)
            out[arch, flash] = dict(
                jm=jm, jp=jp, logits=np.asarray(logits),
                tm=build_model(tcfg, device="cpu"),
                tp=params_from_reference(tree, tcfg, "cpu"))
    return out


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_configs_match_reference(R, arch):
    for get_t, get_j in ((tconfigs.get_config, R.configs.get_config),
                         (tconfigs.get_smoke_config, R.configs.get_smoke_config)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.padded_vocab_size == j.padded_vocab_size
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.activation_dtype == getattr(torch, j.dtype)


def test_registry_matches_reference(R):
    assert tconfigs.ARCHS == R.configs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R.configs.SHAPES.items()}
    for arch in tconfigs.ARCHS:
        for shape in tconfigs.SHAPES:
            assert tconfigs.cell_is_skipped(arch, shape) == \
                R.configs.cell_is_skipped(arch, shape)
    z = tconfigs.get_config("zamba2-7b", use_flash_kernel=True, dtype="float32")
    assert z.use_flash_kernel and z.activation_dtype == torch.float32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_matches_reference(R):
    from repro.models import layers as jl
    x, w = _rand(3, 5, 64), _rand(64, seed=1) * 0.1
    np.testing.assert_allclose(
        _np(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)),
        np.asarray(jl.rms_norm(x, w, 1e-6)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(R, theta):
    from repro.models import layers as jl
    x = _rand(2, 16, 4, 32)
    pos = np.tile(np.arange(16, dtype=np.int32) * 37, (2, 1))
    np.testing.assert_allclose(
        _np(layers.rope_frequencies(32, theta)),
        np.asarray(jl.rope_frequencies(32, theta)), rtol=1e-6)
    np.testing.assert_allclose(
        _np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)),
        np.asarray(jl.apply_rope(x, pos, theta)), atol=1e-5, rtol=1e-5)


def test_host_table_is_built_once_per_device():
    """``host_table`` returns the CPU function's table, the same tensor on
    every later call with the same arguments and device."""
    dev = torch.device("cpu")
    first = layers.host_table(layers.rope_frequencies, dev, 112, 10_000.0)
    assert torch.equal(first, layers.rope_frequencies(112, 10_000.0))
    assert layers.host_table(layers.rope_frequencies, dev, 112, 10_000.0) is first


@requires_cuda
@pytest.mark.parametrize("head_dim,theta", [(112, 10_000.0), (128, 1_000_000.0)])
def test_rope_frequencies_on_card_equal_cpu(head_dim, theta):
    """On the card the inverse frequencies are the CPU's bit for bit: at
    head_dim 112 (zamba2-7b) CUDA's division by the Python number, and at
    both widths its pow, round otherwise (ROADMAP.md Queue 3, item 17)."""
    skip_without_cuda()
    got = layers.rope_frequencies(head_dim, theta, torch.device("cuda"))
    want = layers.rope_frequencies(head_dim, theta)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_mrope_matches_reference(R):
    from repro.models import layers as jl
    x = _rand(2, 8, 4, 16)
    pos = np.random.default_rng(2).integers(0, 50, (3, 2, 8)).astype(np.int32)
    np.testing.assert_allclose(
        _np(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e4, (4, 2, 2))),
        np.asarray(jl.apply_mrope(x, pos, 1e4, (4, 2, 2))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(R, act):
    from repro.models import mlp as jmlp
    p = {k: _rand(*shape, seed=i) * scale for i, (k, (shape, _, scale))
         in enumerate(mlp.mlp_spec(32, 64, act, torch.float32).items())}
    x = _rand(2, 8, 32, seed=9)
    np.testing.assert_allclose(
        _np(mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), act)),
        np.asarray(jmlp.mlp(p, x, act)), atol=1e-5, rtol=1e-5)


def test_embed_and_cross_entropy_match_reference(R):
    from repro.models import layers as jl
    table = _rand(50, 16)
    toks = np.random.default_rng(4).integers(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(layers.embed(torch.from_numpy(table), torch.from_numpy(toks),
                         torch.float32)),
        np.asarray(jl.embed(table, toks, np.float32)))
    logits = _rand(2, 7, 50, seed=5)
    labels = toks.copy()
    labels[0, :3] = -1                                      # masked
    np.testing.assert_allclose(
        float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(R.steps.cross_entropy(logits, labels)), rtol=1e-6)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernel-path"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_matches_reference(ref_models, tokens, arch, flash):
    m = ref_models[arch, flash]
    logits, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(tokens)})
    cfg = m["tm"].config
    assert logits.shape == (B, S, cfg.padded_vocab_size)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), m["logits"], **TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_matches_reference_decode(R, ref_models, tokens, arch):
    """Token by token, the port's decode_step against the reference's."""
    jnp = R.jax.numpy
    m = ref_models[arch, False]
    jstep = R.jax.jit(m["jm"].decode_step)
    jcache = m["jm"].init_cache(B, S)
    tcache = m["tm"].init_cache(B, S)
    for t in range(S):
        jl, jcache = jstep(m["jp"], jcache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = m["tm"].decode_step(m["tp"], tcache,
                                         torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_matches_forward(ref_models, tokens, arch):
    """The port's decode reproduces the port's full forward."""
    m = ref_models[arch, False]
    tm, tp = m["tm"], m["tp"]
    logits, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    cache = tm.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(logits),
                               atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_step_returns_last_logits(ref_models, tokens, arch):
    m = ref_models[arch, True]
    last = make_prefill_step(m["tm"])(m["tp"], {"tokens": torch.from_numpy(tokens)})
    assert last.shape == (B, m["tm"].config.padded_vocab_size)
    assert not last.requires_grad and last.is_inference()
    np.testing.assert_allclose(_np(last), m["logits"][:, -1], **TOL)


def test_prefill_over_chunks_matches_reference(R):
    """A prompt of three SSD chunks (smoke chunk 16) and several attention
    rows per block: the kernel path against the reference's plain path."""
    jax, jnp = R.jax, R.jax.numpy
    toks = np.random.default_rng(11).integers(0, 256, (1, 48)).astype(np.int32)
    jm = R.models.build_model(R.configs.get_smoke_config("zamba2-7b"))
    jp = jm.init(jax.random.PRNGKey(3))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    cfg = tconfigs.get_smoke_config("zamba2-7b", use_flash_kernel=True)
    tm = build_model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want)[:, -1], **TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_init_follows_the_spec_and_the_seed(arch):
    cfg = tconfigs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    p1, p2 = model.init(5), model.init(torch.Generator().manual_seed(5))
    spec = model_spec(cfg)

    def walk(a, b, s, path=""):
        assert set(a) == set(s), path
        for k in s:
            if isinstance(s[k], dict):
                walk(a[k], b[k], s[k], f"{path}/{k}")
            else:
                shape, dtype, _ = s[k]
                assert tuple(a[k].shape) == shape and a[k].dtype == dtype, path + k
                assert torch.equal(a[k], b[k]), path + k
    walk(p1, p2, spec)
    assert not torch.equal(p1["embed"], model.init(6)["embed"])


def test_params_from_reference_rejects_a_wrong_tree(ref_models):
    cfg = tconfigs.get_smoke_config("mamba2-370m")
    tree = {k: v for k, v in model_spec(cfg).items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tree, cfg, "cpu")
    m = ref_models["mamba2-370m", False]
    tree = {k: _np(v) if isinstance(v, torch.Tensor) else v
            for k, v in m["tp"].items()}
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(tree, cfg, "cpu")


def test_unknown_family_raises():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("deepseek-7b"),
                              family="conv")
    with pytest.raises(ValueError, match="unknown family 'conv'"):
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown family 'conv'"):
        model_spec(cfg)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tconfigs.get_smoke_config("zamba2-7b"))


@requires_cuda
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_kernel_path_matches_plain_path_on_card(arch):
    """On the card, the forward through the CUDA kernels against the plain
    path on the same weights (float32 smoke configs, prompt of 3 chunks)."""
    skip_without_cuda()
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ssd
    cfg = tconfigs.get_smoke_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 48))).cuda()
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    kern = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    got = make_prefill_step(kern)(params, {"tokens": toks})
    want = make_prefill_step(model)(params, {"tokens": toks})
    assert ssd.LAUNCHES["ssd_scan"] == cfg.num_layers
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-3, rtol=1e-3)
