"""PyTorch port: Granite-4.0-H-Small, the ``hybrid_moe`` family
(``ModelConfig.layer_types``, ``use_rope``, ``attention_scale``, the three
multipliers, ``MoEConfig.d_ff_shared``; ``configs/granite_4_0_h_small.py``),
on the CPU at small widths in float32 with seeded random weights.

The port's prefill is held to the benchmark's plain float32 reference
(``portbench/reference/granite-4.0-h-small.py``, which imports nothing of
the port) at atol / rtol 1e-4 of logits whose largest is ~0.04: both
float32 on the CPU, the sums' order differs, nothing else.  A port that
rotated q and k, scaled the scores by ``head_dim ** -0.5``, dropped the
residual multiplier or the shared expert is another function, and each
case shows the reference tells it apart.  Decode through the cache (SSM
states, KV caches and the dense MoE path) is held to the full forward
(the row dispatch at capacity E / K) at the repo's decode bar (atol 5e-3,
rtol 1e-3).  The kernel path at the published widths runs on the card
only (``requires_cuda``).
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_port_ref import requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.configs import granite_4_0_h_small as granite
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model, model_spec, moe

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, spec  # noqa: E402

B, S = 2, 48
DECODE_TOL = dict(atol=5e-3, rtol=1e-3)
CELL = "granite-4.0-h-small.prefill-2x4096"


@pytest.fixture(scope="module")
def parts():
    """The benchmark's configuration module and reference at smoke size."""
    _, cfg_mod, ref = spec.config_parts("granite-4.0-h-small")
    return cfg_mod, ref, cfg_mod.smoke_dims()


def _weights(cfg_mod, dims, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg_mod.make_weights(dims, gen, device)


def _tokens(vocab, seed=1, s=S):
    return torch.randint(0, vocab, (B, s),
                         generator=torch.Generator().manual_seed(seed))


def _prefill(cfg, params, tokens):
    return make_prefill_step(build_model(cfg, device="cpu"))(
        params, {"tokens": tokens})


def test_smoke_config_is_the_benchmarks_smoke_layout(parts):
    cfg_mod, _, dims = parts
    ours, theirs = granite.smoke_config(), cfg_mod.port_config(dims)
    assert ours == dataclasses.replace(theirs, name=ours.name)


def test_prefill_matches_the_plain_reference(parts):
    cfg_mod, ref, dims = parts
    cfg = cfg_mod.port_config(dims)
    assert cfg.family == "hybrid_moe" and not cfg.use_rope
    assert cfg.use_flash_kernel and cfg.moe.norm_topk_prob
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"])
    want = ref.forward(params, tokens, dims)
    torch.testing.assert_close(_prefill(cfg, params, tokens), want,
                               rtol=1e-4, atol=1e-4)
    # and on the model's plain attention and SSD (no kernel plain versions)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    torch.testing.assert_close(_prefill(plain, params, tokens), want,
                               rtol=1e-4, atol=1e-4)


MUTANTS = {
    "published": lambda cfg: cfg,
    "rope": lambda cfg: dataclasses.replace(cfg, use_rope=True),
    "head_dim_scale": lambda cfg: dataclasses.replace(cfg, attention_scale=None),
    "no_residual_multiplier": lambda cfg: dataclasses.replace(
        cfg, residual_multiplier=1.0),
    "no_shared_expert": lambda cfg: cfg,
}


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_the_reference_tells_each_departure_apart(parts, mutant, monkeypatch):
    """RoPE on q and k, the scale ``head_dim ** -0.5`` (1/4 here, 1/16
    published), no residual multiplier or no shared expert: each moves the
    logits far past the bar the published layout meets."""
    cfg_mod, ref, dims = parts
    cfg = MUTANTS[mutant](cfg_mod.port_config(dims))
    if mutant == "no_shared_expert":
        monkeypatch.setattr(moe, "_shared_expert", lambda *a: None)
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"])
    got, want = _prefill(cfg, params, tokens), ref.forward(params, tokens, dims)
    rel = check.row_numbers(got.numpy(), want.numpy())["logit_rel_err"]
    if mutant == "published":
        assert float(rel.max()) < 1e-5
    else:
        assert float(rel.min()) > 1e-2, rel


def test_decode_through_the_cache_matches_the_forward(parts):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    assert cfg.moe.capacity_factor == dims["experts"] / dims["top_k"]
    model = build_model(cfg, device="cpu")
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"], s=32)
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, tokens.shape[1])
    assert cache["ssm"].ssd.shape[0] == 4 and cache["kv"].k.shape[0] == 1
    steps = []
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **DECODE_TOL)


def test_gates_are_the_softmax_over_the_top_k_logits(parts):
    """Granite's routing, a softmax over the top-k logits, is the port's
    renormalised top-k of the softmax over every expert."""
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    p = {k: v[0] for k, v in _weights(cfg_mod, dims)["blocks"]["moe"].items()
         if k != "shared"}
    x = torch.randn(64, dims["d_model"], generator=torch.Generator().manual_seed(4))
    gates, eidx, _ = moe._route(p, x, cfg.moe)
    top = (x @ p["router"]).topk(dims["top_k"], dim=-1)
    assert torch.equal(eidx, top.indices)
    torch.testing.assert_close(gates, torch.softmax(top.values, dim=-1))


@pytest.mark.parametrize("ffn", ["moe_ffn", "moe_ffn_flat", "moe_ffn_dense"])
def test_every_moe_path_adds_the_shared_expert(parts, ffn):
    """The row, flat and dense paths each add the shared expert's SwiGLU of
    every token to the routed experts' output, and without it are the
    paths they were."""
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims).moe
    p = {k: v[0] if k != "shared" else {n: w[0] for n, w in v.items()}
         for k, v in _weights(cfg_mod, dims)["blocks"]["moe"].items()}
    x = torch.randn(B, 16, dims["d_model"],
                    generator=torch.Generator().manual_seed(6))
    fn = getattr(moe, ffn)
    with_shared, _ = fn(p, x, cfg, "swiglu")
    routed, _ = fn({k: v for k, v in p.items() if k != "shared"}, x,
                   dataclasses.replace(cfg, d_ff_shared=0), "swiglu")
    sp = p["shared"]
    shared = (torch.nn.functional.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) \
        @ sp["w_down"]
    torch.testing.assert_close(with_shared, routed + shared, rtol=1e-5,
                               atol=1e-6)


def test_dropless_routed_equals_computed(parts):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    spans.reset_counts("moe")
    _prefill(cfg, _weights(cfg_mod, dims), _tokens(dims["vocab"]))
    counts = spans.counts()
    assert counts["moe.routed"] == counts["moe.computed"] == \
        dims["layers"] * B * S * dims["top_k"]
    assert counts["moe.ragged"] == dims["layers"]
    spans.reset_counts("moe")


@pytest.mark.parametrize("layout", ["smoke", "published_types"])
def test_the_mixer_counter_reads_each_kind_a_forward(parts, layout):
    """``mixers.mamba`` and ``mixers.attention`` add one per layer of the
    kind a forward: the smoke layout's 4 and 1, the published 36 and 4 (at
    the smoke widths)."""
    cfg_mod, _, dims = parts
    if layout == "published_types":
        dims = dict(dims, layers=40,
                    layer_types=list(granite.PUBLISHED_LAYER_TYPES))
    cfg = cfg_mod.port_config(dims)
    params = _weights(cfg_mod, dims)
    spans.reset_counts("mixers")
    _prefill(cfg, params, _tokens(dims["vocab"], s=16))
    want = (36, 4) if layout == "published_types" else (4, 1)
    assert (spans.counts()["mixers.mamba"],
            spans.counts()["mixers.attention"]) == want
    spans.reset_counts("mixers")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_published_widths_and_param_count():
    cfg = granite.published_config()
    spec_ = model_spec(cfg)
    assert cfg.layer_types.count("mamba") == 36
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert spec_["ssm"]["in_proj"][0] == (36, 4096, 2 * 8192 + 2 * 128 + 128)
    assert spec_["ssm"]["conv_w"][0] == (36, 4, 8448)
    assert spec_["attn"]["wq"][0] == (4, 4096, 4096)
    assert spec_["attn"]["wk"][0] == (4, 4096, 1024)
    blocks = spec_["blocks"]
    assert blocks["ln1"][0] == blocks["ln2"][0] == (40, 4096)
    assert blocks["moe"]["router"][0] == (40, 4096, 72)
    assert blocks["moe"]["w_gate"][0] == (40, 72, 4096, 768)
    assert blocks["moe"]["shared"]["w_down"][0] == (40, 1536, 4096)
    assert spec_["embed"][0] == (100352, 4096) and "lm_head" not in spec_
    assert cfg.padded_vocab_size == cfg.vocab_size
    total = sum(int(np.prod(leaf[0])) for leaf in _leaves(spec_))
    assert total == cfg.param_count() == 32_207_337_984
    assert cfg.active_param_count() == 8_803_121_664
    assert cfg.moe.capacity_factor * cfg.moe.top_k == cfg.moe.num_experts


def test_registry_entries_are_unchanged():
    """Granite is not in the registry, and no registry entry takes a new
    field off its default: no shared expert, RoPE, the head-dim scale,
    unit multipliers, no layer list."""
    assert "granite-4.0-h-small" not in tconfigs.ARCHS
    for arch in tconfigs.ARCHS:
        for cfg in (tconfigs.get_config(arch), tconfigs.get_smoke_config(arch)):
            assert cfg.layer_types is None and cfg.use_rope
            assert cfg.attention_scale is None
            assert (cfg.embedding_multiplier, cfg.residual_multiplier,
                    cfg.logits_scaling) == (1.0, 1.0, 1.0)
            assert cfg.moe is None or cfg.moe.d_ff_shared == 0
            if cfg.moe is not None and cfg.family != "encdec":
                assert "shared" not in model_spec(cfg)["blocks"]["moe"]


@pytest.mark.parametrize("field", ["embedding_multiplier",
                                   "residual_multiplier", "logits_scaling"])
def test_multipliers_are_the_hybrid_moe_familys(field):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("deepseek-7b"),
                              **{field: 0.5})
    with pytest.raises(ValueError, match=field):
        build_model(cfg, device="cpu")


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_at_published_widths_on_card(dtype):
    """Two layers at the published widths (a Mamba2 and an attention
    mixer), 1 x 2048 tokens: float32, the kernel path (the conv, SSD,
    gated-norm, RMSNorm and flash kernels, the grouped GEMMs) against the
    plain path within 1e-3 of the logits' spread; bf16, the kernel path
    against the float32 reference within the cell's limits."""
    skip_without_cuda()
    doc, cfg_mod, ref = spec.config_parts("granite-4.0-h-small")
    dims = dict(cfg_mod.dims(doc), layers=2, layer_types=["mamba", "attention"],
                dtype=dtype)
    cfg = cfg_mod.port_config(dims)
    params = _weights(cfg_mod, dims, seed=5, device="cuda")
    tokens = torch.randint(0, dims["vocab"], (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    step = make_prefill_step(build_model(cfg, device="cuda"))
    spans.reset_counts()
    got = step(params, {"tokens": tokens})[:, :dims["vocab"]].float().cpu()
    counts = spans.counts()
    assert counts["flash_attention"] == 1 and counts["ssd_scan"] == 1
    assert counts["moe.routed"] == counts["moe.computed"]
    if dtype == "float32":
        plain = make_prefill_step(build_model(
            dataclasses.replace(cfg, use_flash_kernel=False), device="cuda"))
        want = plain(params, {"tokens": tokens})[:, :dims["vocab"]].float().cpu()
        rel = check.row_numbers(got.numpy(), want.numpy())["logit_rel_err"]
        assert float(rel.max()) < 1e-3
        return
    limits = spec.cell(CELL).limits["limits"]
    want = ref.forward(params, tokens, dims).cpu().numpy()
    checks, failed = check.judge(got.numpy(), want, limits)
    assert failed == 0, checks
