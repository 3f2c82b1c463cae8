"""PyTorch port: the moe family (``models/moe.py`` and the MoE branch of the
decoder) against the JAX reference.

The reference's weights (``init_moe`` or ``model.init(PRNGKey(0))``) are
carried into the port; both see the same seeded numpy inputs.  Bars:
``_route`` and the three FFN paths 1e-5 (float32; the expert ids equal);
forward and decode logits of the mixtral and olmoe smoke configs 1e-4,
with and without ``use_flash_kernel`` (the reference's Pallas kernel in
interpret mode, the port's plain version: this is the CPU); the port's
decode against its own forward at ``tests/test_models.py``'s bar (atol
5e-3, rtol 1e-3; the smoke configs' capacity factor 4.0 drops no slot, so
the dense decode path computes what the capacity path does); the
auxiliary loss 1e-6; train-step losses at ``test_torch_train.py``'s bar
(1e-5 relative at each of three steps).  Parameters after each of three
AdamW steps at learning rate 1e-3 are held within 1e-4 absolute, not the
dense family's 1e-5, except where the first gradient is float32 noise
(0 < |g| <= 1e-6): Adam's first update of an element is lr * g / (|g| +
1e-8), and where an element's gradient is noise near that epsilon its
update is anywhere in (-lr, lr) on either side, so such an element is held
to 2 * steps * lr (``torch_port_ref.assert_params_close``; ROADMAP.md
Queue 3 item 14).  Olmoe smoke, layer 1 ``attn/wq[53, 1]``: its first
gradient is ~4.5e-11, and Adam's first step moves it by 0.0045 lr in the
reference and 0.154 lr here (1.5e-4 apart); steps 2 and 3 agree within
8e-6 lr.  The routes of both runs are the same at every step and the
losses agree within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_ref import (assert_params_close, first_step_grads,
                            load_reference, requires_cuda, skip_without_cuda)

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch._tree import items, leaves
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, model_spec, moe, params_from_reference
from repro_torch.models.api import MoEConfig
from repro_torch.optim import adamw as tadamw

ARCHS = ("mixtral-8x22b", "olmoe-1b-7b")
B, S = 2, 32
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_LAYER = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.fixture(scope="module")
def jmoe(R):
    from repro.models import moe as jm
    return jm


def _np(x):
    return x.detach().cpu().numpy()


def _moe_params(R, jmoe, d, cfg, seed=0):
    """The reference's init_moe weights, as numpy and as port tensors."""
    jax = R.jax
    from repro.models.api import MoEConfig as JMoEConfig
    fields = dataclasses.asdict(cfg)
    assert fields.pop("norm_topk_prob")       # the reference renormalises
    assert fields.pop("d_ff_shared") == 0     # and has no shared expert
    jcfg = JMoEConfig(**fields)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), d,
                                                jcfg, jax.numpy.float32))
    return jcfg, jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def test_moe_spec_matches_init_moe(R, jmoe):
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=24)
    _, jp, _ = _moe_params(R, jmoe, 16, cfg)
    spec = moe.moe_spec(16, cfg, torch.bfloat16)
    assert set(spec) == set(jp)
    for k, (shape, dtype, _) in spec.items():
        assert shape == jp[k].shape, k
    assert spec["router"][1] == torch.float32
    assert spec["w_down"][1] == torch.bfloat16
    assert spec["w_down"][2] == 24 ** -0.5 and spec["w_up"][2] == 16 ** -0.5


def test_route_matches_reference(R, jmoe):
    cfg = MoEConfig(num_experts=8, top_k=3, d_ff_expert=16)
    jcfg, jp, tp = _moe_params(R, jmoe, 32, cfg)
    x = _x((40, 32))
    jg, je, jaux = jmoe._route(jp, x, jcfg)
    tg, te, taux = moe._route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL_LAYER)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_flat", "moe_ffn_dense"])
def test_moe_ffn_matches_reference(R, jmoe, fn, act):
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=1.25)
    jcfg, jp, tp = _moe_params(R, jmoe, 16, cfg)
    x = _x((3, 12, 16))
    jy, jaux = getattr(jmoe, fn)(jp, x, jcfg, act)
    ty, taux = getattr(moe, fn)(tp, torch.from_numpy(x), cfg, act)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL_LAYER)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("fn", ["moe_ffn", "moe_ffn_flat"])
def test_low_capacity_drops_the_same_slots(R, jmoe, fn):
    """The port's counterpart of tests/test_models.py's
    test_moe_drops_tokens_at_low_capacity: at capacity factor 0.25 some
    tokens lose their only slot, the same tokens as in the reference."""
    cfg = MoEConfig(num_experts=4, top_k=1, d_ff_expert=32,
                    capacity_factor=0.25)
    jcfg, jp, tp = _moe_params(R, jmoe, 16, cfg)
    x = _x((2, 32, 16))
    jy, _ = getattr(jmoe, fn)(jp, x, jcfg, "swiglu")
    ty, _ = getattr(moe, fn)(tp, torch.from_numpy(x), cfg, "swiglu")
    assert torch.isfinite(ty).all()
    dropped = np.linalg.norm(np.asarray(jy), axis=-1) == 0.0
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(_np(ty.norm(dim=-1) == 0.0), dropped)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL_LAYER)


def test_ample_capacity_equals_the_dense_path():
    """tests/test_models.py's test_moe_capacity_vs_dense_dispatch on the port:
    with capacity E/K nothing drops, and both capacity paths compute what
    the dense path computes."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(shape, generator=gen) * scale
         for k, (shape, _, scale) in moe.moe_spec(16, cfg, torch.float32).items()}
    x = torch.randn((2, 8, 16), generator=gen)
    y_dense, aux_dense = moe.moe_ffn_dense(p, x, cfg, "swiglu")
    for fn in (moe.moe_ffn, moe.moe_ffn_flat):
        y, aux = fn(p, x, cfg, "swiglu")
        np.testing.assert_allclose(_np(y), _np(y_dense), atol=1e-5, rtol=1e-5)
        assert float(aux) == float(aux_dense)


def test_slots_count_positions_per_expert():
    eidx = torch.tensor([[0, 1, 0, 0, 2, 1]])
    slot = moe._slots(eidx, 3, 2)
    # expert 0 takes positions 0, 1 and drops its third pick (spare row 6)
    assert slot.tolist() == [[0, 2, 1, 6, 4, 3]]


def _ragged_case(cf: float, b: int, router: str, e=4, k=2, d=16, f=32,
                 s=12):
    """Weights, input and config for the ragged-vs-padded comparison; a
    ``skewed`` router sends most tokens' first pick to expert 0."""
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)
    gen = torch.Generator().manual_seed(11)
    p = {name: torch.randn(shape, generator=gen) * scale
         for name, (shape, _, scale) in moe.moe_spec(d, cfg, torch.float32).items()}
    x = torch.randn((b, s, d), generator=gen)
    if router == "skewed":
        u = torch.nn.functional.normalize(torch.randn(d, generator=gen), dim=0)
        x = x + 3.0 * u
        p["router"][:, 0] += 5.0 * u
    return p, x, cfg


@pytest.mark.parametrize("router", ["random", "skewed"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("cf", [4.0, 1.25, 0.25])
def test_ragged_rows_match_the_padded_path(cf, b, router):
    """The row path's packed rows and grouped matmuls against the padded
    (E, B*cap, D) buffer and batched matmul of the mesh branch, on the same
    weights: the same outputs, the same tokens zeroed, each kept pick a row
    of its own, and each expert's group ``min(count, cap)`` rows a
    sequence, in sequence and then token order."""
    p, x, cfg = _ragged_case(cf, b, router)
    _, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = int(np.ceil(s * k * cf / e))
    moe.reset_row_counts()
    got, aux = moe.moe_ffn(p, x, cfg, "swiglu")
    assert moe.ROWS["ragged"] == 1
    want, aux_padded = moe._moe_ffn_padded(p, x, cfg, "swiglu", cap)
    moe.reset_row_counts()
    np.testing.assert_allclose(_np(got), _np(want), **TOL_LAYER)
    assert float(aux) == float(aux_padded)
    zeroed = _np(got.norm(dim=-1) == 0.0)
    np.testing.assert_array_equal(zeroed, _np(want.norm(dim=-1) == 0.0))
    assert zeroed.any() == (cf == 0.25)

    _, eidx, _ = moe._route(p, x.reshape(-1, d), cfg)
    flat = eidx.reshape(b, s * k)
    rows = min(b * s * k, b * e * cap)
    row, ends = moe._packed_rows(flat, e, cap, rows)
    kept = moe._slots(flat, e, cap) < e * cap
    assert ends.dtype == torch.int32
    # kept picks: rows 0 .. ends[-1] - 1, each once; dropped: the spare row
    assert sorted(row[kept].tolist()) == list(range(int(ends[-1])))
    assert (row[~kept] == rows).all()
    counts = torch.nn.functional.one_hot(flat, e).sum(dim=1).clamp(max=cap)
    starts = [0] + ends.tolist()[:-1]
    for g in range(e):
        members = [(int(row[i, m]), i, m) for i in range(b)
                   for m in range(s * k) if kept[i, m] and flat[i, m] == g]
        members.sort()
        assert [r for r, _, _ in members] == list(range(starts[g], int(ends[g])))
        # sequence order, then the picks' order within each sequence
        assert [(i, m) for _, i, m in members] == sorted((i, m) for _, i, m in members)
        for i in range(b):
            assert sum(1 for _, j, _ in members if j == i) == int(counts[i, g])


# ---------------------------------------------------------------------------
# the moe models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_models(R, tokens):
    jax, jnp = R.jax, R.jax.numpy
    out = {}
    for arch in ARCHS:
        for flash in (False, True):
            jcfg = R.configs.get_smoke_config(arch, use_flash_kernel=flash)
            jm = R.models.build_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            logits, aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
            tcfg = tconfigs.get_smoke_config(arch, use_flash_kernel=flash)
            out[arch, flash] = dict(
                jm=jm, jp=jp, logits=np.asarray(logits), aux=float(aux),
                tm=build_model(tcfg, device="cpu"),
                tp=params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu"))
    return out


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernel-path"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref_models, tokens, arch, flash):
    m = ref_models[arch, flash]
    logits, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (B, S, m["tm"].config.padded_vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), m["logits"], **TOL)
    np.testing.assert_allclose(float(aux), m["aux"], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_is_the_mean_of_the_layers(ref_models, tokens, arch):
    """The forward's aux is the mean of each layer's Switch loss, in layer
    order (1e-6 of the reference's); it is positive and near 1 for a
    balanced router."""
    from repro_torch.models import transformer
    m = ref_models[arch, False]
    seen = []
    route = moe._route

    def spy(p, xf, cfg):
        out = route(p, xf, cfg)
        seen.append(out[2])
        return out

    moe._route = spy
    try:
        _, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(tokens)})
    finally:
        moe._route = route
    assert len(seen) == m["tm"].config.num_layers
    assert float(aux) == float(torch.stack(seen).mean())
    np.testing.assert_allclose(float(aux), m["aux"], rtol=1e-6)
    assert 0.5 < float(aux) < 4.0 and transformer.moe is moe


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernel-path"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_forward(R, ref_models, tokens, arch,
                                              flash):
    jnp = R.jax.numpy
    m = ref_models[arch, flash]
    logits, _ = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(tokens)})
    jstep = R.jax.jit(m["jm"].decode_step)
    jcache, tcache = m["jm"].init_cache(B, S), m["tm"].init_cache(B, S)
    with torch.inference_mode():
        for t in range(S):
            jl, jcache = jstep(m["jp"], jcache, jnp.asarray(tokens[:, t:t + 1]),
                               jnp.int32(t))
            tl, tcache = m["tm"].decode_step(
                m["tp"], tcache, torch.from_numpy(tokens[:, t:t + 1]), t)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                       err_msg=f"step {t}")
            np.testing.assert_allclose(_np(tl[:, 0]), _np(logits[:, t]),
                                       atol=5e-3, rtol=1e-3, err_msg=f"step {t}")


def test_flat_dispatch_model_matches_reference(R, tokens):
    """olmoe's published config dispatches over one flat buffer; its smoke
    config with ``dispatch="flat"`` and a capacity that drops slots."""
    jax, jnp = R.jax, R.jax.numpy
    base = tconfigs.get_smoke_config("olmoe-1b-7b")
    over = dict(moe=dataclasses.replace(base.moe, dispatch="flat",
                                        capacity_factor=1.0))
    jcfg = R.configs.get_smoke_config(
        "olmoe-1b-7b",
        moe=dataclasses.replace(R.configs.get_smoke_config("olmoe-1b-7b").moe,
                                dispatch="flat", capacity_factor=1.0))
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    want, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
    tcfg = tconfigs.get_smoke_config("olmoe-1b-7b", **over)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _spec_shapes(spec, path=()):
    for k in sorted(spec):
        if isinstance(spec[k], dict):
            yield from _spec_shapes(spec[k], path + (k,))
        else:
            yield path + (k,), spec[k][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_the_reference_tree(R, ref_models, arch):
    m = ref_models[arch, False]
    shapes = dict(_spec_shapes(model_spec(m["tm"].config)))
    flat_ref = dict(items(R.jax.tree.map(np.asarray, m["jp"])))
    assert set(shapes) == set(flat_ref)
    for path, shape in shapes.items():
        assert shape == flat_ref[path].shape, path
    assert m["tp"]["blocks"]["moe"]["router"].dtype == torch.float32


def test_init_follows_the_spec_and_the_seed():
    cfg = tconfigs.get_smoke_config("mixtral-8x22b", dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    p1, p2 = model.init(3), model.init(torch.Generator().manual_seed(3))
    for a, b in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b)
    blk = p1["blocks"]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["w_gate"].dtype == torch.bfloat16
    assert tuple(blk["moe"]["w_down"].shape) == (2, 4, 64, 64)
    assert "mlp" not in blk


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 17)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("accum", ["inside", "outside"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(R, arch, accum):
    """Three steps: losses within 1e-5 relative; parameters within 1e-4
    where the port's first gradient is clear of float32 noise, the noise
    elements within 2 * steps * lr (under 1 % of each leaf; ROADMAP.md
    Queue 3 item 14)."""
    jax, jnp = R.jax, R.jax.numpy
    jcfg = R.configs.get_smoke_config(arch, train_microbatches=2)
    jm = R.models.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke_config(arch, train_microbatches=2)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jo = R.adamw.adamw(R.adamw.AdamWConfig(learning_rate=LR))
    to = tadamw.adamw(tadamw.AdamWConfig(learning_rate=LR))
    jst, tst = jo.init(jp), to.init(tp)
    jstep = jax.jit(R.steps.make_train_step(jm, jo, grad_accum=accum))
    tstep = tsteps.make_train_step(tm, to, grad_accum=accum)
    tbatch = lambda toks: {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                           "labels": torch.from_numpy(toks[:, 1:].copy())}
    batches = _batches(3)
    g1 = first_step_grads(tm, tp, tbatch(batches[0]), grad_accum=accum)
    for step, toks in enumerate(batches, 1):
        jp, jst, jmet = jstep(jp, jst, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "labels": jnp.asarray(toks[:, 1:])})
        tp, tst, tmet = tstep(tp, tst, tbatch(toks))
        assert float(tmet["aux_loss"]) > 0.0
        for k in ("loss", "aux_loss", "total_loss"):
            want = float(jmet[k])
            assert abs(float(tmet[k]) - want) <= 1e-5 * abs(want), k
        assert_params_close(items(tp), jax.tree.leaves(jp), g1, atol=1e-4,
                            steps=step, lr=LR)


def test_train_cli_trains_a_moe_smoke_model(tmp_path):
    from repro_torch.launch import train
    tr = train.main(["--arch", "olmoe-1b-7b", "--steps", "3", "--batch", "2",
                     "--seq-len", "8", "--pods", "2", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])
    assert len(tr.history) == 3
    assert all(np.isfinite(h["loss"]) for h in tr.history)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_matches_plain_path_on_card(arch):
    """The forward through the flash kernel against the plain path on the
    same weights, float32 smoke configs, on the card (the dense prefill's
    bar, 2e-3 / 1e-3); the same routes in both."""
    skip_without_cuda()
    from repro_torch.kernels import flash_attention as fa
    cfg = tconfigs.get_smoke_config(arch)
    plain = build_model(cfg, device="cuda")
    kern = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    params = plain.init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 48))).cuda()
    spans.reset_counts()
    with torch.inference_mode():
        got, aux_k = kern.forward(params, {"tokens": toks})
        assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
        want, aux_p = plain.forward(params, {"tokens": toks})
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(float(aux_k), float(aux_p), rtol=1e-5)


@requires_cuda
def test_ragged_rows_match_the_padded_path_on_card_without_a_sync():
    """bf16 at E 8, K 2, D 256, F 512, S 512, B 2: the row path's grouped
    matmuls against the padded buffer's batched matmul within bf16's
    tolerance (torch.testing's rtol, atol at that share of the output's
    rms), and no host sync (stream or device synchronize, device-to-host
    copy) inside the call."""
    skip_without_cuda()
    cpu = torch.profiler.ProfilerActivity.CPU
    cuda = torch.profiler.ProfilerActivity.CUDA
    p, x, cfg = _ragged_case(4.0, 2, "random", e=8, k=2, d=256, f=512, s=512)
    p = {name: w.cuda().to(torch.bfloat16) if name != "router" else w.cuda()
         for name, w in p.items()}
    x = x.cuda().to(torch.bfloat16)
    cap = int(np.ceil(512 * 2 * 4.0 / 8))
    with torch.inference_mode():
        moe.moe_ffn(p, x, cfg, "swiglu")                  # warm up
        torch.cuda.synchronize()
        moe.reset_row_counts()
        with torch.profiler.profile(activities=[cpu, cuda]) as prof:
            got, _ = moe.moe_ffn(p, x, cfg, "swiglu")
        assert moe.ROWS == {"routed": 2 * 512 * 2, "computed": 2 * 512 * 2,
                            "ragged": 1}
        moe.reset_row_counts()
        want, _ = moe._moe_ffn_padded(p, x, cfg, "swiglu", cap)
    events = prof.events()
    (call,) = [ev for ev in events if ev.name == "moe"]
    inside = {ev.name for ev in events
              if call.time_range.start <= ev.time_range.start
              and ev.time_range.end <= call.time_range.end}
    assert "aten::_grouped_mm" in inside
    assert not [n for n in inside if "Synchronize" in n or "DtoH" in n
                or n.startswith("cudaMemcpy")], sorted(inside)
    assert got.dtype == torch.bfloat16
    scale = float(want.float().pow(2).mean().sqrt())
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1.6e-2 * scale)


@requires_cuda
def test_moe_train_step_replays_bit_equal_on_card():
    skip_without_cuda()
    cfg = tconfigs.get_smoke_config("olmoe-1b-7b", train_microbatches=2,
                                    remat="full")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = tadamw.adamw()
    state = opt.init(params)
    step = tsteps.make_train_step(model, opt)
    toks = torch.from_numpy(_batches(1)[0]).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    a = step(params, state, batch)
    b = step(params, state, batch)
    assert torch.equal(a[2]["total_loss"], b[2]["total_loss"])
    for x, y in zip(leaves(a[:2]), leaves(b[:2])):
        assert torch.equal(x, y)
