"""PyTorch port: the published Zamba2-7B layout (``HybridConfig.layer_ids``,
``configs/zamba2_7b.py`` ``published_config``), on the CPU at small widths
in float32 with seeded random weights.

The port's prefill is held to the benchmark's plain float32 reference
(``portbench/reference/zamba2-7b.py``, which imports nothing of the port)
at atol / rtol 1e-4: both float32 on the CPU, the sums' order differs,
nothing else.  Decode through the cache (one KV cache per shared-block
call, one SSM state per layer) is held to the full forward at the repo's
decode bar (atol 5e-3, rtol 1e-3).  The structure: blocks by turns, one
adapter per call, no residual inside a shared block, the grouped gated
norm.  The flash kernel at head dim 224 against its plain version runs on
the card only (``requires_cuda``).
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_ref import requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.configs import zamba2_7b
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model, layers, model_spec, ssm, transformer
from repro_torch.models.api import HybridConfig, SSMConfig
from repro_torch.models.attention import gqa_scores_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import spec  # noqa: E402

B, S = 2, 48
DECODE_TOL = dict(atol=5e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def parts():
    """The benchmark's configuration module and reference at smoke size."""
    _, cfg_mod, ref = spec.config_parts("zamba2-7b")
    return cfg_mod, ref, cfg_mod.smoke_dims()


def _weights(cfg_mod, dims, seed=0):
    return cfg_mod.make_weights(dims, torch.Generator().manual_seed(seed), "cpu")


def _tokens(vocab, seed=1, s=S):
    return torch.randint(0, vocab, (B, s),
                         generator=torch.Generator().manual_seed(seed))


def _forward(cfg, params, tokens):
    return build_model(cfg, device="cpu").forward(params, {"tokens": tokens})[0]


def test_smoke_config_is_the_benchmarks_smoke_layout(parts):
    cfg_mod, _, dims = parts
    ours, theirs = zamba2_7b.published_smoke_config(), cfg_mod.port_config(dims)
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "rope_theta", "norm_eps", "tie_embeddings",
                  "ssm", "hybrid", "dtype", "pad_vocab_multiple"):
        assert getattr(ours, field) == getattr(theirs, field), field


def test_prefill_matches_the_plain_reference(parts):
    cfg_mod, ref, dims = parts
    cfg = cfg_mod.port_config(dims)
    assert cfg.hybrid.published and cfg.use_flash_kernel
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"])
    got = make_prefill_step(build_model(cfg, device="cpu"))(
        params, {"tokens": tokens})[:, :dims["vocab"]]
    want = ref.forward(params, tokens, dims)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # and on the model's plain attention (no flash plain version)
    plain = _forward(dataclasses.replace(cfg, use_flash_kernel=False), params,
                     tokens)[:, -1, :dims["vocab"]]
    torch.testing.assert_close(plain, want, rtol=1e-4, atol=1e-4)


def test_decode_through_the_cache_matches_the_forward(parts):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    model = build_model(cfg, device="cpu")
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"], s=32)
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, tokens.shape[1])
    n_calls, h = len(dims["hybrid_ids"]), cfg.hybrid
    assert cache["shared_kv"].k.shape == (n_calls, B, tokens.shape[1],
                                          h.shared_num_kv_heads, dims["head_dim"])
    assert cache["ssm"].ssd.shape[0] == dims["layers"]
    steps = []
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **DECODE_TOL)


def test_published_cache_is_one_kv_per_call_and_one_state_per_layer():
    cfg = zamba2_7b.published_config()
    cache = build_model(cfg, device="cpu").init_cache(1, 4)
    assert tuple(cache["shared_kv"].k.shape) == (13, 1, 4, 32, 224)
    assert tuple(cache["shared_kv"].v.shape) == (13, 1, 4, 32, 224)
    assert tuple(cache["ssm"].ssd.shape) == (81, 1, 112, 64, 64)
    assert tuple(cache["ssm"].conv.shape) == (81, 1, 3, 7168 + 2 * 2 * 64)


def test_blocks_by_turns_and_one_adapter_per_call(parts, monkeypatch):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"])
    base = _forward(cfg, params, tokens)
    # calls 0 and 2 both run block 0; their adapters are their own
    swapped = {**params, "calls": {k: v[[2, 1, 0, 3]]
                                   for k, v in params["calls"].items()}}
    assert not torch.allclose(_forward(cfg, swapped, tokens), base, atol=1e-3)
    # which block and which call each shared-block call reads
    used = []
    real = transformer._published_block

    def watched(p, call, *args):
        used.append((next(j for j in range(dims["blocks"])
                          if p["ln1"].data_ptr()
                          == params["shared"]["ln1"][j].data_ptr()),
                     next(k for k in range(len(dims["hybrid_ids"]))
                          if call["proj"].data_ptr()
                          == params["calls"]["proj"][k].data_ptr())))
        return real(p, call, *args)

    monkeypatch.setattr(transformer, "_published_block", watched)
    _forward(cfg, params, tokens)
    assert used == [(0, 0), (1, 1), (0, 2), (1, 3)]


def test_no_residual_inside_a_shared_block(parts):
    """With every call's projection zero the model is its Mamba2 layers
    alone: the ssm family's model on the same layers, bit for bit."""
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    params = _weights(cfg_mod, dims)
    params["calls"]["proj"].zero_()
    tokens = _tokens(dims["vocab"])
    ssm_cfg = dataclasses.replace(cfg, family="ssm", hybrid=None)
    alone = {"embed": params["embed"], "final_norm": params["final_norm"],
             "blocks": params["layers"]}
    assert set(model_spec(ssm_cfg)) == set(alone)
    assert torch.equal(_forward(cfg, params, tokens),
                       _forward(ssm_cfg, alone, tokens))


def test_grouped_gated_norm():
    gen = torch.Generator().manual_seed(4)
    y, z = torch.randn(2, 5, 24, generator=gen), torch.randn(2, 5, 24, generator=gen)
    w = torch.randn(24, generator=gen) * 0.1
    h = y * F.silu(z)
    g = h.reshape(2, 5, 2, 12)
    want = (g * torch.rsqrt(g.square().mean(-1, keepdim=True) + 1e-5)
            ).reshape(2, 5, 24) * (1 + w)
    torch.testing.assert_close(ssm.gated_norm(y, z, w, 2, 1e-5), want,
                               rtol=1e-6, atol=1e-6)
    # groups of the norm are no longer one RMS over the whole width
    assert not torch.allclose(ssm.gated_norm(y, z, w, 2, 1e-5),
                              ssm.gated_norm(y, z, w, 1, 1e-5), atol=1e-3)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, v = y.to(dtype), z.to(dtype), w.to(dtype)
        assert torch.equal(ssm.gated_norm(a, b, v, 1, 1e-5),
                           layers.rms_norm(a * F.silu(b), v, 1e-5))


def test_registry_zamba2_is_unchanged():
    cfg = tconfigs.get_config("zamba2-7b")
    assert cfg.hybrid == HybridConfig(shared_every=6, shared_num_heads=32,
                                      shared_num_kv_heads=32)
    assert not cfg.hybrid.published and cfg.ssm.n_groups == 1
    assert cfg.ssm == SSMConfig(state_dim=64, head_dim=64, expand=2,
                                chunk_size=256)
    assert set(model_spec(cfg)) == {"embed", "final_norm", "lm_head", "main",
                                    "shared", "tail"}
    assert tconfigs.get_smoke_config("zamba2-7b").hybrid.layer_ids is None


def test_published_widths_and_param_count():
    cfg = zamba2_7b.published_config()
    spec_ = model_spec(cfg)
    n = {k: sum(int(np.prod(v[0])) for v in _leaves(t))
         for k, t in spec_.items() if isinstance(t, dict)}
    assert spec_["layers"]["ssm"]["in_proj"][0] == (81, 3584, 14704)
    assert spec_["shared"]["attn"]["wq"][0] == (2, 7168, 7168)
    assert spec_["shared"]["attn"]["wo"][0] == (2, 7168, 3584)
    assert spec_["shared"]["mlp"]["w_gate_up"][0] == (2, 3584, 28672)
    assert spec_["calls"]["lora_b"][0] == (13, 128, 28672)
    assert spec_["calls"]["proj"][0] == (13, 3584, 3584)
    assert n["calls"] == 13 * (4_128_768 + 12_845_056)
    assert cfg.param_count() == 7_352_819_712
    # the shared attention as Zamba2Config derives it
    assert cfg.hybrid.attention_width(3584) == 7168
    assert cfg.hybrid.head_dim(3584) == 224
    assert cfg.hybrid.softmax_scale(3584) == 112 ** -0.5
    assert tconfigs.get_config("zamba2-7b").hybrid.softmax_scale(3584) is None
    assert cfg.param_count() == pytest.approx(
        sum(n.values()) + spec_["embed"][0][0] * 3584, rel=1e-3)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("d", [112, 224])
def test_flash_plain_path_takes_a_softmax_scale(d):
    gen = torch.Generator().manual_seed(d)
    q = torch.randn(2, 40, 4, d, generator=gen)
    k, v = torch.randn(2, 40, 2, d, generator=gen), torch.randn(2, 40, 2, d, generator=gen)
    scale = (d / 2) ** -0.5
    kr, vr = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kr) * scale
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    want = torch.einsum("bhst,bthd->bshd", probs, vr)
    got = ops.flash_attention(q, k, v, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        gqa_scores_reference(q, k, v, causal=True, sliding_window=None,
                             scale=scale), want, rtol=1e-5, atol=1e-5)
    # the default is head_dim ** -0.5, bit for bit as before
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v, scale=d ** -0.5))
    assert torch.equal(
        gqa_scores_reference(q, k, v, causal=True, sliding_window=None),
        gqa_scores_reference(q, k, v, causal=True, sliding_window=None,
                             scale=d ** -0.5))


def test_head_dim_224_runs_the_mma_kernel():
    assert 224 in fa.SUPPORTED_HEAD_DIMS
    assert fa.BF16_KERNEL[224] == "flash_mma_kernel"
    assert fa.BF16_TILES[224] == fa.BF16_TILES[256] == (64, 32, 2)


@requires_cuda
@pytest.mark.parametrize("s", [4096, 4000, 129])
def test_flash_kernel_at_224_matches_plain_on_card(s):
    """bf16 at (64, 4096, 224), the published Zamba2's shared attention at
    2 x 4096, and ragged lengths, within ``PLAIN_TOL``."""
    skip_without_cuda()
    bh, d = 64, 224
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    q = (q.float() * (d / 2) ** -0.5).to(torch.bfloat16)
    spans.reset_counts()
    got = fa.flash_attention_bhsd(q, k, v, group=1)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    want = fa.flash_attention_reference(q, k, v, group=1)
    atol, rtol = fa.PLAIN_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol, rtol=rtol)
