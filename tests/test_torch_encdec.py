"""PyTorch port: the Whisper-style encoder-decoder (``models/encdec.py``),
``layers.layer_norm`` and ``attention.cross_attention`` against the JAX
reference.

The reference's ``init(PRNGKey(0))`` weights are carried into the port with
``params_from_reference``; frames and tokens are seeded numpy arrays handed
to both.  Bars: layers 1e-5 (float32; bfloat16 ``layer_norm`` within about
one bf16 ulp of outputs of order 1, atol 2e-2 / rtol 1e-2); forward and
decode logits 1e-4, with and without ``use_flash_kernel`` (the reference's
Pallas kernel in interpret mode, the port's plain version: this is the
CPU); decode with the encoder's output against the forward at
``tests/test_models.py``'s bar (atol 5e-3, rtol 1e-3); train-step losses
1e-5 relative at each of three steps (``test_torch_train.py``'s bar).
Parameters after three AdamW steps at learning rate 1e-3 are held within
1e-4 absolute, not the dense family's 1e-5: a key bias shifts all of a
query's scores by one constant, so its gradient is zero in exact
arithmetic, and Adam's update lr * g / (|g| + 1e-8) turns each
framework's rounding noise into a step of up to lr (measured worst
6.1e-5, ``enc_layers/attn/bk``; the other leaves 1.2e-5 or less).  Two
reference behaviours are pinned as they are: the decoder's self-attention
applies RoPE on top of the learned positions, and cross-attention adds no
QKV bias.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import load_reference, requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch._tree import items
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, encdec, layers, model_spec
from repro_torch.models import params_from_reference
from repro_torch.optim import adamw as tadamw

ARCH = "whisper-medium"
B, S = 2, 24
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_LAYER = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _np(x):
    return x.detach().cpu().numpy()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(R, dtype):
    from repro.models import layers as jl
    jnp = R.jax.numpy
    x = _rand(3, 5, 64) * 3 + 1
    w, b = 1 + _rand(64, seed=1) * 0.1, _rand(64, seed=2) * 0.1
    want = np.asarray(jl.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                    jnp.asarray(b, dtype), 1e-5)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = layers.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                            torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    tol = TOL_LAYER if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(got.float()), want, **tol)


def test_layer_norm_uses_the_population_variance():
    x = torch.from_numpy(_rand(4, 16))
    w, b = torch.ones(16), torch.zeros(16)
    want = torch.nn.functional.layer_norm(x, (16,), w, b, 1e-5)
    np.testing.assert_allclose(_np(layers.layer_norm(x, w, b, 1e-5)), _np(want),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("length,channels", [(32, 64), (7, 10)])
def test_sinusoids_match_reference(R, length, channels):
    from repro.models import encdec as jed
    got = encdec._sinusoids(length, channels)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jed._sinusoids(length, channels)),
                               **TOL_LAYER)


def test_sinusoids_at_whisper_length(R):
    """whisper-medium's 1500 x 1024 table.  The float32 timescale step is
    the reference's bit for bit; ``torch.exp`` and XLA's ``exp`` differ by one
    ulp on some of the 512 inverse frequencies, and the argument t * inv
    carries that ulp times t: up to 1499 * 2^-23 ~ 1.8e-4 at the last frame,
    so the table is held there at 2e-4 (the sines themselves are within
    4e-8 of float64 in both)."""
    import jax.numpy as jnp
    from repro.models import encdec as jed
    c = 1024
    inv_ref = np.asarray(jnp.exp(-(jnp.log(10_000.0) / (c // 2 - 1))
                                 * jnp.arange(c // 2)))
    step = torch.log(torch.tensor(10_000.0)) / (c // 2 - 1)
    assert float(step) == float(jnp.log(10_000.0) / (c // 2 - 1))
    inv = torch.exp(-step * torch.arange(c // 2, dtype=torch.float32)).numpy()
    assert np.abs(inv.view(np.int32) - inv_ref.view(np.int32)).max() <= 1
    np.testing.assert_allclose(_np(encdec._sinusoids(1500, c)),
                               np.asarray(jed._sinusoids(1500, c)), atol=2e-4,
                               rtol=0)


def _attn_params(d, heads, hd, bias_scale, seed):
    spec = tattn.attn_spec(d, heads, heads, hd, True, torch.float32)
    p = {}
    for i, (k, (shape, _, scale)) in enumerate(spec.items()):
        s = bias_scale if scale == "zeros" else scale
        p[k] = _rand(*shape, seed=seed + i) * s
    return p


def test_cross_attention_matches_reference_and_ignores_biases(R):
    from repro.models import attention as ja
    cfg = tconfigs.get_smoke_config(ARCH)
    jcfg = R.configs.get_smoke_config(ARCH)
    p = _attn_params(cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, 0.5, 3)
    x, src = _rand(2, 5, cfg.d_model, seed=9), _rand(2, 11, cfg.d_model, seed=10)
    want = np.asarray(ja.cross_attention(p, x, src, jcfg, cfg.num_heads,
                                         cfg.num_kv_heads))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(src),
                                cfg, cfg.num_heads, cfg.num_kv_heads)
    np.testing.assert_allclose(_np(got), want, **TOL_LAYER)
    # the biases (nonzero here) change nothing, in the reference and here
    no_bias = {k: v for k, v in tp.items() if not k.startswith("b")}
    np.testing.assert_array_equal(
        _np(tattn.cross_attention(no_bias, torch.from_numpy(x),
                                  torch.from_numpy(src), cfg, cfg.num_heads,
                                  cfg.num_kv_heads)), _np(got))
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    q = (torch.from_numpy(x) @ tp["wq"] + tp["bq"]).reshape(2, 5, h, hd)
    k = (torch.from_numpy(src) @ tp["wk"] + tp["bk"]).reshape(2, 11, h, hd)
    v = (torch.from_numpy(src) @ tp["wv"] + tp["bv"]).reshape(2, 11, h, hd)
    with_bias = tattn.gqa_scores_reference(q, k, v, causal=False,
                                           sliding_window=None)
    with_bias = with_bias.reshape(2, 5, -1) @ tp["wo"]
    assert not np.allclose(_np(with_bias), want, atol=1e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(R):
    cfg = tconfigs.get_smoke_config(ARCH)
    rng = np.random.default_rng(5)
    return {"frames": rng.standard_normal((B, cfg.encdec.enc_len, cfg.d_model)
                                          ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref_models(R, inputs):
    jax, jnp = R.jax, R.jax.numpy
    out = {}
    for flash in (False, True):
        jcfg = R.configs.get_smoke_config(ARCH, use_flash_kernel=flash)
        jm = R.models.build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        logits, aux = jax.jit(jm.forward)(
            jp, {k: jnp.asarray(v) for k, v in inputs.items()})
        tcfg = tconfigs.get_smoke_config(ARCH, use_flash_kernel=flash)
        out[flash] = dict(jm=jm, jp=jp, logits=np.asarray(logits),
                          aux=float(aux), tm=build_model(tcfg, device="cpu"),
                          tp=params_from_reference(jax.tree.map(np.asarray, jp),
                                                   tcfg, "cpu"))
    return out


def _tbatch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernel-path"])
def test_forward_matches_reference(ref_models, inputs, flash):
    m = ref_models[flash]
    logits, aux = m["tm"].forward(m["tp"], _tbatch(inputs))
    assert logits.shape == (B, S, m["tm"].config.padded_vocab_size)
    assert logits.dtype == torch.float32 and float(aux) == m["aux"] == 0.0
    np.testing.assert_allclose(_np(logits), m["logits"], **TOL)


def _reference_encode(R, jp, frames, jcfg):
    """tests/test_models.py's _encode_for_test: the reference's encoder,
    which its Model does not expose."""
    jax = R.jax
    from repro.models import attention as ja, mlp as jmlp
    from repro.models.encdec import _ln, _sinusoids
    x = jax.numpy.asarray(frames)
    x = x + _sinusoids(x.shape[1], jcfg.d_model).astype(x.dtype)[None]

    def body(carry, lp):
        h = carry + ja.attention(lp["attn"], _ln(carry, lp["ln1"], 1e-5), None,
                                 jcfg, causal=False)
        h = h + jmlp.mlp(lp["mlp"], _ln(h, lp["ln2"], 1e-5), "gelu")
        return h, None

    x, _ = jax.lax.scan(body, x, jp["enc_layers"])
    return _ln(x, jp["enc_norm"], 1e-5)


def test_encode_matches_reference(R, ref_models, inputs):
    m = ref_models[False]
    want = _reference_encode(R, m["jp"], inputs["frames"], m["jm"].config)
    got = encdec.encode(m["tp"], torch.from_numpy(inputs["frames"]),
                        m["tm"].config)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL_LAYER)


def test_decode_with_the_encoder_output(R, ref_models, inputs):
    """Token by token with ``enc_out`` from the encoder: against the
    reference's decode on the same ``enc_out`` (1e-4) and the port's own
    forward (5e-3 / 1e-3)."""
    jnp = R.jax.numpy
    m = ref_models[False]
    tm, tp = m["tm"], m["tp"]
    toks = inputs["tokens"]
    logits, _ = tm.forward(tp, _tbatch(inputs))
    tcache, jcache = tm.init_cache(B, S), m["jm"].init_cache(B, S)
    assert tcache["enc_out"].shape == tuple(jcache["enc_out"].shape)
    assert float(tcache["enc_out"].abs().max()) == 0.0
    enc = encdec.encode(tp, torch.from_numpy(inputs["frames"]), tm.config)
    tcache["enc_out"] = enc
    jcache["enc_out"] = jnp.asarray(_np(enc))
    jstep = R.jax.jit(m["jm"].decode_step)
    with torch.inference_mode():
        for t in range(S):
            jl, jcache = jstep(m["jp"], jcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                       err_msg=f"step {t}")
            np.testing.assert_allclose(_np(tl[:, 0]), _np(logits[:, t]),
                                       atol=5e-3, rtol=1e-3, err_msg=f"step {t}")


def test_decoder_self_attention_applies_rope(ref_models, inputs):
    """Reference behaviour kept as it is: the decoder's self-attention
    rotates q and k (``positions`` passed) on top of ``dec_pos``; the
    encoder's gets ``positions=None``.  Without the rotation the logits move
    away from the reference's."""
    m = ref_models[False]
    calls = []
    orig = tattn.attention

    def spy(p, x, positions, cfg, **kw):
        calls.append(positions is not None)
        return orig(p, x, positions, cfg, **kw)

    def no_rope(p, x, positions, cfg, **kw):
        return orig(p, x, None, cfg, **kw)

    try:
        tattn.attention = spy
        m["tm"].forward(m["tp"], _tbatch(inputs))
        tattn.attention = no_rope
        unrotated, _ = m["tm"].forward(m["tp"], _tbatch(inputs))
    finally:
        tattn.attention = orig
    cfg = m["tm"].config
    assert calls == [False] * cfg.encdec.enc_layers + [True] * cfg.num_layers
    assert not np.allclose(_np(unrotated), m["logits"], atol=1e-3)


def test_spec_matches_the_reference_tree(R, ref_models):
    def shapes(spec, path=()):
        for k in sorted(spec):
            if isinstance(spec[k], dict):
                yield from shapes(spec[k], path + (k,))
            else:
                yield path + (k,), spec[k]

    m = ref_models[False]
    spec = dict(shapes(model_spec(m["tm"].config)))
    ref = dict(items(R.jax.tree.map(np.asarray, m["jp"])))
    assert set(spec) == set(ref)
    for path, (shape, dtype, how) in spec.items():
        assert shape == ref[path].shape, path
        if path[-1] == "w" and "ln" in "".join(path[-2:-1]) + "norm":
            assert how == "ones"
    params = m["tm"].init(0)
    assert float(params["enc_norm"]["w"].min()) == 1.0
    assert float(params["dec_layers"]["ln3"]["b"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# training and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", ["inside", "outside"])
def test_train_step_matches_reference(R, accum):
    jax, jnp = R.jax, R.jax.numpy
    jcfg = R.configs.get_smoke_config(ARCH, train_microbatches=2)
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke_config(ARCH, train_microbatches=2)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=1e-3))
    to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=1e-3))
    jst, tst = jo.init(jp), to.init(tp)
    jstep = jax.jit(R.steps.make_train_step(jm, jo, grad_accum=accum))
    tstep = tsteps.make_train_step(tm, to, grad_accum=accum)
    rng = np.random.default_rng(3)
    for _ in range(3):
        frames = rng.standard_normal((4, tcfg.encdec.enc_len, tcfg.d_model)
                                     ).astype(np.float32)
        toks = rng.integers(0, tcfg.vocab_size, (4, 17)).astype(np.int32)
        batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jp, jst, jmet = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tst, tmet = tstep(tp, tst, {k: torch.from_numpy(v.copy())
                                        for k, v in batch.items()})
        for k in ("loss", "total_loss"):
            want = float(jmet[k])
            assert abs(float(tmet[k]) - want) <= 1e-5 * abs(want), k
        assert float(tmet["aux_loss"]) == 0.0
    for (path, t), j in zip(items(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-4, rtol=0,
                                   err_msg=str(path))


def test_train_cli_refuses_the_encoder_decoder(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", ARCH, "--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])


def test_serve_cli_serves_encdec_and_moe(capsys):
    from repro_torch.launch import serve
    for arch in (ARCH, "mixtral-8x22b"):
        serve.main(["--arch", arch, "--batch", "3", "--prompt-len", "4",
                    "--gen", "5", "--device", "cpu"])
        out = capsys.readouterr().out
        assert out.startswith(f"{arch}: 3x5 tokens (bucket 4)"), out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@requires_cuda
def test_sinusoids_on_card_equal_cpu():
    """whisper-medium's 1500 x 1024 table on the card is the CPU's bit for
    bit: built there, CUDA's exp, sin and cos differ from the CPU's by an
    ulp on some arguments, a third of the table's entries in all (ROADMAP.md
    Queue 3, item 17)."""
    skip_without_cuda()
    got = encdec._sinusoids(1500, 1024, torch.device("cuda"))
    want = encdec._sinusoids(1500, 1024)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@requires_cuda
def test_kernel_path_matches_plain_path_on_card():
    """Decoder self-attention through the flash kernel (one launch per
    decoder layer, none for the encoder or cross-attention) against the
    plain path on the same weights, float32, on the card."""
    skip_without_cuda()
    from repro_torch.kernels import flash_attention as fa
    cfg = tconfigs.get_smoke_config(ARCH)
    plain = build_model(cfg, device="cuda")
    kern = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    params = plain.init(0)
    rng = np.random.default_rng(2)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)).cuda(),
             "tokens": torch.from_numpy(rng.integers(0, 256, (2, 48))).cuda()}
    spans.reset_counts()
    with torch.inference_mode():
        got, _ = kern.forward(params, batch)
        assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
        want, _ = plain.forward(params, batch)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-3, rtol=1e-3)
