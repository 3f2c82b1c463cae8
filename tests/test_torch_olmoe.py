"""PyTorch port: the published OLMoE-1B-7B layout (``ModelConfig.qk_norm``,
``MoEConfig.norm_topk_prob``, ``configs/olmoe_1b_7b.py``
``published_config``), on the CPU at small widths in float32 with seeded
random weights.

The port's prefill is held to the benchmark's plain float32 reference
(``portbench/reference/olmoe-1b-7b.py``, which imports nothing of the port)
at atol / rtol 1e-4: both float32 on the CPU, the sums' order differs,
nothing else.  Decode through the cache (the dense MoE path) is held to the
full forward (the row dispatch at capacity E / K) at the repo's decode bar
(atol 5e-3, rtol 1e-3).  The structure: one RMSNorm over the whole q and
the whole k width, the gates as the softmax gave them, no pick dropped.
The kernel path at the published widths runs on the card only
(``requires_cuda``).
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
from repro_torch.configs import olmoe_1b_7b
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention, build_model, layers, model_spec, moe
from repro_torch.models.api import MoEConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, spec  # noqa: E402

B, S = 2, 48
DECODE_TOL = dict(atol=5e-3, rtol=1e-3)
CELL = "olmoe-1b-7b.prefill-2x4096"


@pytest.fixture(scope="module")
def parts():
    """The benchmark's configuration module and reference at smoke size."""
    _, cfg_mod, ref = spec.config_parts("olmoe-1b-7b")
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
    ours, theirs = olmoe_1b_7b.published_smoke_config(), cfg_mod.port_config(dims)
    assert ours == dataclasses.replace(theirs, name=ours.name)


def test_prefill_matches_the_plain_reference(parts):
    cfg_mod, ref, dims = parts
    cfg = cfg_mod.port_config(dims)
    assert cfg.qk_norm and not cfg.moe.norm_topk_prob and cfg.use_flash_kernel
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"])
    want = ref.forward(params, tokens, dims)
    torch.testing.assert_close(_prefill(cfg, params, tokens), want,
                               rtol=1e-4, atol=1e-4)
    # and on the model's plain attention (no flash plain version)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    torch.testing.assert_close(_prefill(plain, params, tokens), want,
                               rtol=1e-4, atol=1e-4)


def test_decode_through_the_cache_matches_the_forward(parts):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    assert cfg.moe.capacity_factor == dims["experts"] / dims["top_k"]
    model = build_model(cfg, device="cpu")
    params = _weights(cfg_mod, dims)
    tokens = _tokens(dims["vocab"], s=32)
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, tokens.shape[1])
    steps = []
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **DECODE_TOL)


def _per_head(x, w, heads, eps):
    """The norm a per-head QK-norm would take: one RMS a head."""
    b, s, _ = x.shape
    return layers.rms_norm(x.reshape(b, s, heads, -1), w.reshape(heads, -1),
                           eps).reshape(b, s, -1)


@pytest.mark.parametrize("norm", ["whole", "per_head"])
def test_qk_norm_is_over_the_whole_width(parts, norm):
    """q and k each take one RMS over all their channels, before the heads
    are split and rotated; a per-head norm is another function."""
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    p = {k: v[0] for k, v in _weights(cfg_mod, dims)["blocks"]["attn"].items()}
    x = torch.randn(B, 8, dims["d_model"], generator=torch.Generator().manual_seed(3))
    q, k, _ = attention._project_qkv(p, x, cfg, dims["heads"], dims["kv_heads"])
    eps = dims["eps"]
    if norm == "whole":
        want_q = layers.rms_norm(x @ p["wq"], p["q_norm"], eps)
        want_k = layers.rms_norm(x @ p["wk"], p["k_norm"], eps)
    else:
        want_q = _per_head(x @ p["wq"], p["q_norm"], dims["heads"], eps)
        want_k = _per_head(x @ p["wk"], p["k_norm"], dims["kv_heads"], eps)
    close = torch.allclose(q.reshape(want_q.shape), want_q, atol=1e-5) \
        and torch.allclose(k.reshape(want_k.shape), want_k, atol=1e-5)
    assert close == (norm == "whole")


@pytest.mark.parametrize("renormalise", [False, True])
def test_gates_are_not_renormalised(parts, renormalise):
    """The gates are the top-k softmax probabilities, summing below 1 a
    token; a port that renormalises them departs from the reference."""
    cfg_mod, ref, dims = parts
    cfg = cfg_mod.port_config(dims)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, norm_topk_prob=renormalise))
    params = _weights(cfg_mod, dims)
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(64, dims["d_model"], generator=torch.Generator().manual_seed(4))
    gates, eidx, _ = moe._route(p, x, cfg.moe)
    top = torch.softmax(x @ p["router"], dim=-1).topk(dims["top_k"], dim=-1)
    assert torch.equal(eidx, top.indices)
    sums = gates.sum(dim=-1)
    if renormalise:
        torch.testing.assert_close(sums, torch.ones_like(sums))
    else:
        assert torch.equal(gates, top.values) and bool((sums < 1).all())
    tokens = _tokens(dims["vocab"])
    got, want = _prefill(cfg, params, tokens), ref.forward(params, tokens, dims)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4) == (not renormalise)


def test_dropless_no_pick_reads_the_spare_row(parts, monkeypatch):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    rows = []
    real = moe._packed_rows

    def watched(flat_e, e, cap, spare):
        row, ends = real(flat_e, e, cap, spare)
        rows.append((row, spare, cap, flat_e.shape[1] // dims["top_k"]))
        return row, ends

    monkeypatch.setattr(moe, "_packed_rows", watched)
    spans.reset_counts("moe")
    _prefill(cfg, _weights(cfg_mod, dims), _tokens(dims["vocab"]))
    counts = spans.counts()
    assert counts["moe.routed"] == counts["moe.computed"] == \
        dims["layers"] * B * S * dims["top_k"]
    assert len(rows) == dims["layers"]
    for row, spare, cap, seq in rows:
        assert cap == seq and bool((row < spare).all())
        assert sorted(row.flatten().tolist()) == list(range(spare))


def test_the_qk_norm_span_is_recorded(parts):
    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    step = make_prefill_step(build_model(cfg, device="cpu"))
    params, tokens = _weights(cfg_mod, dims), _tokens(dims["vocab"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, {"tokens": tokens})
    names = [e.name for e in prof.events()]
    assert names.count("attn.qk_norm") == names.count("attn") == dims["layers"]


@requires_cuda
def test_the_qk_norm_launches_lie_inside_the_span_on_card(parts, monkeypatch):
    """On the card the RMSNorm kernel's launches of the q and k norms lie
    inside ``attn.qk_norm``, two a layer, so ``qk_norm_share`` reads them:
    each launch is marked on the host and found in the span's range."""
    skip_without_cuda()
    from repro_torch.kernels import rms_norm as rn

    cfg_mod, _, dims = parts
    cfg = cfg_mod.port_config(dims)
    real = rn._launch_cuda

    def marked(*args):
        with torch.profiler.record_function("test.rms_norm_launch"):
            return real(*args)

    monkeypatch.setattr(rn, "_launch_cuda", marked)
    step = make_prefill_step(build_model(cfg, device="cuda"))
    params = _weights(cfg_mod, dims, device="cuda")
    tokens = _tokens(dims["vocab"]).cuda()
    step(params, {"tokens": tokens})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, {"tokens": tokens})
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    spans_of = {name: [(t0, t1) for n, t0, t1 in events if n == name]
                for name in ("attn", "attn.qk_norm")}
    launches = [(t0, t1) for n, t0, t1 in events if n == "test.rms_norm_launch"]
    assert len(launches) == 4 * dims["layers"] + 1

    def inside(ev, name):
        return any(t0 <= ev[0] and ev[1] <= t1 for t0, t1 in spans_of[name])

    in_attn = [ev for ev in launches if inside(ev, "attn")]
    assert len(in_attn) == 2 * dims["layers"]
    assert all(inside(ev, "attn.qk_norm") for ev in in_attn)


def test_registry_olmoe_is_unchanged():
    cfg = tconfigs.get_config("olmoe-1b-7b")
    assert cfg.moe == MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                                capacity_factor=1.25, dispatch="flat")
    assert cfg.moe.norm_topk_prob and not cfg.qk_norm
    assert set(model_spec(cfg)["blocks"]["attn"]) == {"wq", "wk", "wv", "wo"}
    assert not tconfigs.get_smoke_config("olmoe-1b-7b").qk_norm


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_published_widths_and_param_count():
    cfg = olmoe_1b_7b.published_config()
    spec_ = model_spec(cfg)
    blocks = spec_["blocks"]
    assert blocks["attn"]["wq"][0] == (16, 2048, 2048)
    assert blocks["attn"]["q_norm"][0] == blocks["attn"]["k_norm"][0] == (16, 2048)
    assert blocks["moe"]["router"][0] == (16, 2048, 64)
    assert blocks["moe"]["w_gate"][0] == (16, 64, 2048, 1024)
    assert blocks["moe"]["w_down"][0] == (16, 64, 1024, 2048)
    assert spec_["embed"][0] == (50304, 2048) and spec_["lm_head"][0] == (2048, 50304)
    total = sum(int(np.prod(leaf[0])) for leaf in _leaves(spec_))
    experts = 16 * 64 * 3 * 2048 * 1024
    assert total == 6_919_161_856
    assert total - experts + experts // 8 == 1_282_017_280
    # param_count counts no block or final RMSNorm weight (2 a layer and
    # one), for every config alike; the QK-norms it counts
    assert cfg.param_count() == total - (2 * 16 + 1) * 2048
    assert cfg.active_param_count() == 1_282_017_280 - (2 * 16 + 1) * 2048
    assert cfg.moe.capacity_factor * cfg.moe.top_k == cfg.moe.num_experts


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_at_published_widths_on_card(dtype):
    """Two layers at the published widths, 1 x 2048 tokens: float32, the
    kernel path (flash, the grouped GEMMs) against the plain path within
    1e-3 of the logits' spread; bf16, the kernel path against the float32
    reference within the cell's limits."""
    skip_without_cuda()
    doc, cfg_mod, ref = spec.config_parts("olmoe-1b-7b")
    dims = dict(cfg_mod.dims(doc), layers=2, dtype=dtype)
    cfg = cfg_mod.port_config(dims)
    params = _weights(cfg_mod, dims, seed=5, device="cuda")
    tokens = torch.randint(0, dims["vocab"], (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    step = make_prefill_step(build_model(cfg, device="cuda"))
    spans.reset_counts()
    got = step(params, {"tokens": tokens})[:, :dims["vocab"]].float().cpu()
    assert spans.counts()["flash_attention"] == dims["layers"]
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
