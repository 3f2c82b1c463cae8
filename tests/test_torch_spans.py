"""PyTorch port: the spans inside the prefill path and the port's counters
(``repro_torch.spans``; ``models/moe.py``'s ``ROWS``,
``models/transformer.py``'s ``SHARED`` and ``MIXERS`` and the kernels'
``LAUNCHES`` are counters it declares), on the CPU.

A prefill of a tiny MoE model (row and flat dispatch), of a tiny Mamba2
model and of the published Zamba2, OLMoE and Granite layouts at tiny
widths, under
``torch.profiler``, records each documented span the
documented number of times, nested as documented, and each span's range
holds the operators launched inside it.  Off (no profiler, a profile that
does not collect the CPU's activity or that no caller holds, or
``off()``), a span calls no ``record_function`` and a
``TorchDispatchMode`` sees the operators of an unmarked prefill; the
logits are bit-equal either way.  The row counter adds tokens x top-k and
the experts' rows from shapes, and its expert rows are the rows of the
buffers that reach the experts.
"""
import contextlib
import dataclasses
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_ref import requires_cuda, skip_without_cuda

from repro_torch import configs as tconfigs
from repro_torch import spans
from repro_torch.configs import granite_4_0_h_small, olmoe_1b_7b, zamba2_7b
from repro_torch.kernels import (causal_conv, flash_attention, gate_norm,
                                 renewal_scan, rms_norm, ssd_scan)
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.api import MoEConfig

B, S = 2, 32
CPU = torch.profiler.ProfilerActivity.CPU

# per layer: (span, its parent)
MOE_LAYER = [("attn", "prefill"), ("attn.flash", "attn"), ("moe", "prefill"),
             ("moe.router", "moe"), ("moe.dispatch", "moe"),
             ("moe.experts", "moe"), ("moe.combine", "moe")]
SSM_LAYER = [("ssm", "prefill"), ("ssm.conv", "ssm"), ("ssm.scan", "ssm"),
             ("ssm.gate_norm", "ssm")]
ONCE = [("prefill", None), ("embed", "prefill"), ("head", "prefill")]

# operators that, inside the span's family (``moe``, ``ssm``), fall in it
OPS_IN = {"moe.router": ("aten::topk", "aten::softmax"),
          "moe.dispatch": ("aten::index_put_", "aten::cumsum"),
          "moe.experts": ("aten::bmm", "aten::_grouped_mm"),
          "moe.combine": ("aten::index_select", "aten::cat"),
          "ssm.conv": ("aten::constant_pad_nd",),
          "ssm.gate_norm": ("aten::rsqrt",)}


def _model(arch: str, dispatch=None):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              use_flash_kernel=True)
    if dispatch is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, tsteps.make_prefill_step(model), params, {"tokens": tokens}


CASES = [("mixtral-8x22b", "row", MOE_LAYER),
         ("mixtral-8x22b", "flat", MOE_LAYER),
         ("mamba2-370m", None, SSM_LAYER)]


def _profile(step, params, batch, n: int):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            step(params, batch)
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _parent(ev, found):
    """The innermost span around ``ev`` (None outside every span)."""
    name, t0, t1 = ev
    around = [e for e in found if e is not ev and e[1] <= t0 and t1 <= e[2]
              and (e[2] - e[1]) >= (t1 - t0)]
    return min(around, key=lambda e: e[2] - e[1])[0] if around else None


@pytest.mark.parametrize("arch,dispatch,layer", CASES,
                         ids=["moe-row", "moe-flat", "mamba2"])
def test_prefill_records_the_documented_spans(arch, dispatch, layer):
    cfg, step, params, batch = _model(arch, dispatch)
    n = 2
    events = _profile(step, params, batch, n)
    found = [e for e in events if e[0] in spans.NAMES]
    want = {}
    for name, parent in ONCE + layer * cfg.num_layers:
        want[(name, parent)] = want.get((name, parent), 0) + n
    got = {}
    for ev in found:
        key = (ev[0], _parent(ev, found))
        got[key] = got.get(key, 0) + 1
    assert got == want
    # each operator that starts inside a span ends inside it, and the
    # operators of each part fall in its span
    ops = [e for e in events if e[0].startswith("aten::")]
    for name, t0, t1 in found:
        for _, s0, s1 in ops:
            if t0 <= s0 <= t1:
                assert s1 <= t1
    for span_name, op_names in OPS_IN.items():
        ranges = [(t0, t1) for name, t0, t1 in found if name == span_name]
        family = [(t0, t1) for name, t0, t1 in found
                  if name == span_name.split(".")[0]]
        for op, s0, s1 in ops:
            if op in op_names and any(t0 <= s0 <= t1 for t0, t1 in family):
                assert any(t0 <= s0 and s1 <= t1 for t0, t1 in ranges), \
                    (op, span_name)


@pytest.mark.parametrize("arch,dispatch,layer", CASES,
                         ids=["moe-row", "moe-flat", "mamba2"])
def test_logits_bit_equal_with_spans_on_and_off(arch, dispatch, layer):
    _, step, params, batch = _model(arch, dispatch)
    off = step(params, batch)
    with torch.profiler.profile(activities=[CPU]) as prof:
        assert spans.is_recording()
        on = step(params, batch)
        with spans.off():
            off_profiled = step(params, batch)
    assert prof.events()
    assert torch.equal(off, on) and torch.equal(off, off_profiled)



def _recording_under_unbound_profile() -> bool:
    with torch.profiler.profile(activities=[CPU]):
        return spans.is_recording()


def test_recording_rule():
    assert not spans.is_recording()
    with torch.profiler.profile(activities=[CPU]) as prof:
        assert spans.is_recording()
        with spans.off():
            assert not spans.is_recording()
            with spans.off():
                assert not spans.is_recording()
            assert not spans.is_recording()
        assert spans.is_recording()
        # the rule reads the running profile's activities: one that does
        # not list the CPU's (a CUDA-only profile on a card) records none
        prof.activities = {torch.profiler.ProfilerActivity.CUDA}
        assert not spans.is_recording()
        prof.activities = {CPU}
        assert spans.is_recording()
    assert not spans.is_recording()
    # a finished profile in a caller's frame is no running one
    assert prof.profiler.kineto_results is not None
    # a profile no caller holds: its activities are unknown, no range
    assert not _recording_under_unbound_profile()
    with pytest.raises(ValueError):
        spans.span("no.such.span")
    with pytest.raises(ValueError):
        spans.spanned("no.such.span")


def test_the_outermost_span_decides_once(monkeypatch):
    _, step, params, batch = _model("mamba2-370m")
    looks = []
    real = spans._profile_collects_cpu

    def counting():
        looks.append(1)
        return real()

    monkeypatch.setattr(spans, "_profile_collects_cpu", counting)
    step(params, batch)
    assert looks == []
    with torch.profiler.profile(activities=[CPU]) as prof:
        step(params, batch)
    assert len(looks) == 1
    names = [e.name for e in prof.events() if e.name in spans.NAMES]
    assert names.count("prefill") == 1 and names.count("ssm.scan") > 1
    assert spans._outer is None


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,dispatch", [("mixtral-8x22b", "row"),
                                           ("mamba2-370m", None)])
def test_off_spans_call_nothing(arch, dispatch, monkeypatch):
    _, step, params, batch = _model(arch, dispatch)
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with _Ops() as marked:
        out = step(params, batch)
    assert calls == []
    with torch.profiler.profile(activities=[CPU]) as prof:
        prof.activities = {torch.profiler.ProfilerActivity.CUDA}
        step(params, batch)
        prof.activities = {CPU}
        with spans.off():
            step(params, batch)
        assert calls == []
        step(params, batch)
    assert calls and set(calls) <= set(spans.NAMES)
    # the operators of a prefill with every span replaced by a bare context
    monkeypatch.setattr(spans, "span", lambda name: contextlib.nullcontext())
    with _Ops() as bare:
        plain = step(params, batch)
    assert marked.names == bare.names
    assert not any("profiler" in n for n in marked.names)
    assert torch.equal(out, plain)


def _moe_params(d: int, cfg: MoEConfig):
    gen = torch.Generator().manual_seed(3)
    return {k: torch.randn(shape, generator=gen) * scale
            for k, (shape, _, scale) in moe.moe_spec(d, cfg, torch.float32).items()}


def test_row_counts_from_shapes():
    b, s, d = 2, 8, 16
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=1.5)
    p = _moe_params(d, cfg)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(4))
    e, k, n = cfg.num_experts, cfg.top_k, b * s
    moe.reset_row_counts()
    assert moe.ROWS == {"routed": 0, "computed": 0, "ragged": 0}
    moe.moe_ffn(p, x, cfg, "swiglu")
    cap = math.ceil(s * k * 1.5 / e)                       # 6 a sequence
    packed = min(n * k, e * cap * b)                       # 32 of 48 padded
    assert packed == n * k < e * cap * b
    assert moe.ROWS == {"routed": n * k, "computed": packed, "ragged": 1}
    moe.reset_row_counts()
    moe.moe_ffn_flat(p, x, cfg, "swiglu")
    cap = math.ceil(n * k * 1.5 / e)                       # 12 over all
    assert moe.ROWS == {"routed": n * k, "computed": e * cap, "ragged": 0}
    moe.reset_row_counts()
    moe.moe_ffn_dense(p, x, cfg, "swiglu")
    assert moe.ROWS == {"routed": n * k, "computed": e * n, "ragged": 0}
    moe.moe_ffn(p, x, cfg, "swiglu")                       # counts add up
    assert moe.ROWS == {"routed": 2 * n * k, "computed": e * n + packed,
                        "ragged": 1}
    assert spans.counts()["moe.routed"] == 2 * n * k
    assert spans.counts()["moe.computed"] == e * n + packed
    assert spans.counts()["moe.ragged"] == 1
    moe.reset_row_counts()
    assert moe.ROWS == {"routed": 0, "computed": 0, "ragged": 0}


@pytest.mark.parametrize("ffn", ["moe_ffn", "moe_ffn_flat", "moe_ffn_dense"])
def test_computed_rows_are_the_experts_input_rows(ffn, monkeypatch):
    b, s, d = 2, 8, 16
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=1.5)
    p = _moe_params(d, cfg)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(5))
    seen = []
    real, real_ragged = moe._experts, moe._experts_ragged

    def watched(bufr, *args):
        seen.append(bufr.shape[0] * bufr.shape[1])
        return real(bufr, *args)

    def watched_ragged(xs, *args):
        seen.append(xs.shape[0])
        return real_ragged(xs, *args)

    monkeypatch.setattr(moe, "_experts", watched)
    monkeypatch.setattr(moe, "_experts_ragged", watched_ragged)
    moe.reset_row_counts()
    getattr(moe, ffn)(p, x, cfg, "swiglu")
    assert len(seen) == 1 and moe.ROWS["computed"] == seen[0]
    moe.reset_row_counts()


def test_counts_carries_the_launch_counters():
    """``counts()`` is exactly the counters the imported modules declare,
    under their keys, and ``spans.py`` imports none of those modules."""
    import ast
    import pathlib

    counted = spans.counts()
    declared = {}
    for mod in (flash_attention, ssd_scan, renewal_scan, gate_norm, causal_conv,
                rms_norm):
        declared.update(mod.LAUNCHES)
    declared.update({f"moe.{k}": v for k, v in moe.ROWS.items()})
    declared.update({f"shared.{k}": v for k, v in transformer.SHARED.items()})
    declared.update({f"mixers.{k}": v for k, v in transformer.MIXERS.items()})
    assert counted == declared
    assert set(counted) == {"flash_attention", "ssd_scan", "renewal_scan",
                            "gate_norm", "causal_conv", "rms_norm", "moe.routed",
                            "moe.computed", "moe.ragged", "shared.calls",
                            "mixers.mamba", "mixers.attention"}
    assert all(isinstance(v, int) for v in counted.values())
    source = pathlib.Path(spans.__file__).read_text()
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert imported == {"__future__", "contextlib", "functools", "sys",
                        "typing", "torch"}
    assert "repro_torch" not in source and "sys.modules" not in source


def test_counts_after_the_same_calls():
    """After a reset, three MoE FFN calls and a prefill of the published
    Zamba2 layout on the CPU, ``counts()`` reads what the counters read
    when each module kept its own dict: the same keys, the same values."""
    spans.reset_counts()
    assert set(spans.counts().values()) == {0}
    d = 16
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=1.5)
    p = _moe_params(d, cfg)
    x = torch.randn((2, 8, d), generator=torch.Generator().manual_seed(4))
    for ffn in (moe.moe_ffn, moe.moe_ffn_flat, moe.moe_ffn_dense):
        ffn(p, x, cfg, "swiglu")
    _, step, params, batch = _published()
    step(params, batch)
    want = {"flash_attention": 0, "ssd_scan": 0, "gate_norm": 0,
            "causal_conv": 0, "rms_norm": 0, "renewal_scan": 0, "moe.routed": 96,
            "moe.computed": 144,
            "moe.ragged": 1, "shared.calls": 4, "mixers.mamba": 0,
            "mixers.attention": 0}
    assert spans.counts() == want
    moe.reset_row_counts()                      # the MoE counter alone
    assert spans.counts() == {**want, "moe.routed": 0, "moe.computed": 0,
                              "moe.ragged": 0}
    spans.reset_counts()
    assert set(spans.counts().values()) == {0}


@requires_cuda
@pytest.mark.parametrize("published", [False, True], ids=["mamba2", "zamba2-ids"])
def test_kernel_path_counts_one_gate_norm_launch_a_layer(published):
    """On the card, a kernel-path prefill of a small SSM config launches the
    gated-norm kernel once a layer (the published layout's two groups too),
    and ``counts()`` reads it."""
    skip_without_cuda()
    cfg = zamba2_7b.published_smoke_config() if published \
        else tconfigs.get_smoke_config("mamba2-370m")
    model = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    step = tsteps.make_prefill_step(model)
    spans.reset_counts()
    step(params, {"tokens": tokens.cuda()})
    step(params, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert spans.counts()["gate_norm"] == 2 * cfg.num_layers
    spans.reset_counts()
    assert spans.counts()["gate_norm"] == 0


@requires_cuda
@pytest.mark.parametrize("family", ["mamba2", "zamba2-ids", "olmoe-ids"])
def test_kernel_path_counts_one_rms_norm_launch_a_norm(family):
    """On the card a kernel-path prefill launches the RMSNorm kernel once a
    norm, and ``counts()`` reads it: a block norm a layer and the final norm
    on the ssm decoder; one a Mamba layer, two a shared-block call and the
    final on the published hybrid; two block norms, the q and the k norm a
    layer and the final on the published OLMoE."""
    skip_without_cuda()
    if family == "mamba2":
        cfg = tconfigs.get_smoke_config("mamba2-370m")
        norms = cfg.num_layers + 1
    elif family == "zamba2-ids":
        cfg = zamba2_7b.published_smoke_config()
        norms = cfg.num_layers + 2 * len(cfg.hybrid.layer_ids) + 1
    else:
        cfg = olmoe_1b_7b.published_smoke_config()
        norms = 4 * cfg.num_layers + 1
    model = build_model(dataclasses.replace(cfg, use_flash_kernel=True), "cuda")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    step = tsteps.make_prefill_step(model)
    spans.reset_counts()
    step(params, {"tokens": tokens.cuda()})
    step(params, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert spans.counts()["rms_norm"] == 2 * norms
    spans.reset_counts()
    assert spans.counts()["rms_norm"] == 0


# --- the published Zamba2's shared blocks ----------------------------------

def _published(**overrides):
    cfg = dataclasses.replace(zamba2_7b.published_smoke_config(),
                              use_flash_kernel=True, **overrides)
    model = build_model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, tsteps.make_prefill_step(model), model.init(0), \
        {"tokens": tokens}


def test_the_shared_spans_are_named():
    assert {"shared", "shared.mlp"} <= set(spans.NAMES)
    assert spans.span("shared") is spans.span("shared.mlp")   # both off


def test_published_hybrid_records_the_shared_spans():
    cfg, step, params, batch = _published()
    n, calls = 2, len(cfg.hybrid.layer_ids)
    events = _profile(step, params, batch, n)
    found = [e for e in events if e[0] in spans.NAMES]
    got = {}
    for ev in found:
        key = (ev[0], _parent(ev, found))
        got[key] = got.get(key, 0) + 1
    want = {(name, parent): count * n for name, parent, count in (
        ("prefill", None, 1), ("embed", "prefill", 1), ("head", "prefill", 1),
        ("shared", "prefill", calls), ("attn", "shared", calls),
        ("attn.flash", "attn", calls), ("shared.mlp", "shared", calls),
        ("ssm", "prefill", cfg.num_layers), ("ssm.conv", "ssm", cfg.num_layers),
        ("ssm.scan", "ssm", cfg.num_layers),
        ("ssm.gate_norm", "ssm", cfg.num_layers))}
    assert got == want
    # the concat and the call's projection are the shared span's own
    ops = [e for e in events if e[0] in ("aten::cat", "aten::addmm")]
    mlp = [(t0, t1) for name, t0, t1 in found if name == "shared.mlp"]
    own = [(t0, t1) for name, t0, t1 in found if name == "shared"]
    for op, s0, s1 in ops:
        if op == "aten::addmm":
            assert any(t0 <= s0 and s1 <= t1 for t0, t1 in mlp)
        elif any(t0 <= s0 <= t1 for t0, t1 in own):
            assert not any(t0 <= s0 <= t1 for t0, t1 in mlp)


def test_published_hybrid_bit_equal_with_spans_on_and_off():
    _, step, params, batch = _published()
    off = step(params, batch)
    with torch.profiler.profile(activities=[CPU]) as prof:
        assert spans.is_recording()
        on = step(params, batch)
        with spans.off():
            off_profiled = step(params, batch)
    assert prof.events()
    assert torch.equal(off, on) and torch.equal(off, off_profiled)


@pytest.mark.parametrize("published", [False, True], ids=["smoke", "ids"])
def test_shared_calls_counts_each_call(published):
    """``shared.calls`` adds one per shared-block call: the smoke layout's
    own ids, and the published 13 over 81 layers (at tiny widths)."""
    overrides = {}
    if published:
        overrides = dict(num_layers=81, hybrid=dataclasses.replace(
            zamba2_7b.published_smoke_config().hybrid,
            layer_ids=zamba2_7b.PUBLISHED_LAYER_IDS))
    cfg, step, params, batch = _published(**overrides)
    spans.reset_counts()
    step(params, batch)
    step(params, batch)
    calls = len(cfg.hybrid.layer_ids)
    assert calls == (13 if published else 4)
    assert spans.counts()["shared.calls"] == 2 * calls
    spans.reset_counts()
    assert spans.counts()["shared.calls"] == 0


# --- the published OLMoE's QK-norm -----------------------------------------

def test_published_olmoe_records_the_qk_norm_span():
    """``attn.qk_norm`` inside ``attn`` beside ``attn.flash``, and the MoE
    spans inside ``moe``, once a layer (the lists above stay as they are:
    their configs have no QK-norm)."""
    cfg = olmoe_1b_7b.published_smoke_config()
    assert cfg.qk_norm and cfg.use_flash_kernel
    model = build_model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    n = 2
    events = _profile(tsteps.make_prefill_step(model), model.init(0),
                      {"tokens": tokens}, n)
    found = [e for e in events if e[0] in spans.NAMES]
    got = {}
    for ev in found:
        key = (ev[0], _parent(ev, found))
        got[key] = got.get(key, 0) + 1
    layer = MOE_LAYER + [("attn.qk_norm", "attn")]
    assert got == {key: n * (1 if key in ONCE else cfg.num_layers)
                   for key in ONCE + layer}
    # the norms' operators fall in the span
    ranges = [(t0, t1) for name, t0, t1 in found if name == "attn.qk_norm"]
    rsqrt = [(s0, s1) for name, s0, s1 in events if name == "aten::rsqrt"
             and any(t0 <= s0 <= t1 for _, t0, t1 in
                     [e for e in found if e[0] == "attn"])]
    assert len(rsqrt) == 2 * n * cfg.num_layers
    assert all(any(t0 <= s0 and s1 <= t1 for t0, t1 in ranges)
               for s0, s1 in rsqrt)


# --- Granite-4.0-H's layers: a Mamba2 or attention mixer, then the MoE FFN --

def test_granite_records_its_layers_spans():
    """A Mamba2 layer's ``ssm.*`` spans, or an attention layer's ``attn``
    and ``attn.flash``, then ``moe.router``, ``moe.dispatch``,
    ``moe.experts``, ``moe.shared_expert`` and ``moe.combine`` inside
    ``moe``, once a layer (the lists above stay as they are: their configs
    have no shared expert); the shared expert's products fall in its span."""
    cfg = granite_4_0_h_small.smoke_config()
    assert cfg.use_flash_kernel and cfg.moe.d_ff_shared
    model = build_model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    n = 2
    events = _profile(tsteps.make_prefill_step(model), model.init(0),
                      {"tokens": tokens}, n)
    found = [e for e in events if e[0] in spans.NAMES]
    got = {}
    for ev in found:
        key = (ev[0], _parent(ev, found))
        got[key] = got.get(key, 0) + 1
    n_mamba = cfg.layer_types.count("mamba")
    n_attn = cfg.layer_types.count("attention")
    moe_layer = [key for key in MOE_LAYER if key[0].startswith("moe")] \
        + [("moe.shared_expert", "moe")]
    want = {key: n for key in ONCE}
    for key in SSM_LAYER:
        want[key] = n * n_mamba
    for key in MOE_LAYER[:2]:
        want[key] = n * n_attn
    for key in moe_layer:
        want[key] = n * cfg.num_layers
    assert got == want
    ranges = [(t0, t1) for name, t0, t1 in found if name == "moe.shared_expert"]
    moe_ranges = [(t0, t1) for name, t0, t1 in found if name == "moe"]
    outside = [(t0, t1) for name, t0, t1 in found
               if name in ("moe.experts", "moe.router", "moe.dispatch",
                           "moe.combine")]
    mms = [(s0, s1) for name, s0, s1 in events if name == "aten::mm"
           and any(t0 <= s0 <= t1 for t0, t1 in moe_ranges)
           and not any(t0 <= s0 <= t1 for t0, t1 in outside)]
    assert len(mms) == 3 * n * cfg.num_layers
    assert all(any(t0 <= s0 and s1 <= t1 for t0, t1 in ranges)
               for s0, s1 in mms)
