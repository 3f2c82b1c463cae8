"""granite-4.0-h-small's work function against counts made by hand: at its
smoke sizes, and at the published sizes of its cell (2 x 4096); the reader
of the shared expert's share on a hand-made trace."""
import pytest

from portbench.lib import peaks, runner, spec
from portbench.lib import trace as tr

E = tr.Event


def test_granite_work_by_hand():
    cfg = spec.config_parts("granite-4.0-h-small")[1]
    w = cfg.work(cfg.smoke_dims(), batch=2, seq=32)
    t = 64
    # a Mamba2 layer: in_proj 64 x (2*128 + 2*16 + 8), out_proj 128 x 64
    mamba = 64 * 296 + 128 * 64
    # an attention layer: q and o 64 x 64 each, k and v 64 x 32 each
    attention = 2 * 64 * 64 + 2 * 64 * 32
    # every layer's FFN: the router 64 x 8, 3 experts of three 64 x 32
    # products, the shared expert's three 64 x 48
    ffn = 64 * 8 + 3 * 3 * 64 * 32 + 3 * 64 * 48
    assert (mamba, attention, ffn) == (27_136, 12_288, 28_160)
    assert w["matmul_flop"] == 2 * t * (4 * mamba + attention + 5 * ffn) \
        + 2 * 2 * 64 * 250
    # 4 query heads of 16 at batch 2 on 2 KV heads; float32 smoke: q and the
    # output 8 x 32 x 16, k and v 4 x 32 x 16
    flash = (4 * 16 * 8 * (32 * 33 // 2), 4 * (2 * 8 + 2 * 4) * 32 * 16)
    assert w["flash"] == [flash]
    ssd_flop = 2 * 8 * 2 * (16 * 17 * 32 + 4 * 16 * 16 * 16)
    assert w["ssd"][0][0] == ssd_flop and len(w["ssd"]) == 4
    assert w["flop"] == w["matmul_flop"] + flash[0] + 4 * ssd_flop


def test_granite_published_work():
    doc, cfg, _ = spec.config_parts("granite-4.0-h-small")
    d = cfg.dims(doc)
    assert (d["layers"], d["d_model"], d["vocab"]) == (40, 4096, 100352)
    assert (d["heads"], d["kv_heads"], d["head_dim"], d["scale"]) == \
        (32, 8, 128, 1 / 128)
    assert (d["experts"], d["top_k"], d["d_expert"], d["d_shared"]) == \
        (72, 10, 768, 1536)
    assert (d["ssm_heads"], d["ssm_head_dim"], d["state"], d["groups"],
            d["chunk"]) == (128, 64, 128, 1, 256)
    assert d["capacity_factor"] * d["top_k"] == d["experts"]
    w = cfg.work(d, batch=2, seq=4096)
    # a token's multiply-adds: 36 Mamba2 layers of 102.2M, 4 attention
    # layers of 41.9M, 40 FFNs of 113.6M (router 0.29M, 10 experts 94.4M,
    # the shared expert 18.9M); the head at 2 positions
    assert 36 * 102_236_160 + 4 * 41_943_040 + 40 * 113_541_120 \
        == 8_389_918_720
    assert w["matmul_flop"] == 2 * 8192 * 8_389_918_720 + 2 * 2 * 4096 * 100352
    # 4 flash launches at (2 x 32, 4096, 128) on 2 x 8 KV heads
    assert w["flash"] == [(4 * 128 * 64 * (4096 * 4097 // 2),
                           2 * (64 + 16) * 4096 * 128 * 2)] * 4
    assert len(w["ssd"]) == 36
    assert w["ssd"][0][0] == peaks.ssd_work(2, 128, 4096, 64, 128, 256)
    assert w["flop"] == pytest.approx(
        w["matmul_flop"] + 4 * w["flash"][0][0] + 36 * w["ssd"][0][0])
    assert w["flop"] == pytest.approx(1.417e14, rel=1e-3)


def _shared_expert_ctx(with_span=True):
    """The experts' GEMM in ``moe.experts``, the shared expert's GEMM and
    gate in ``moe.shared_expert``, the combine's gather in ``moe.combine``
    and the logits' copy outside every span."""
    shared = [E("moe.shared_expert", "user_annotation", False, 110, 160, 0, 1)]
    events = [
        E("portbench.window", "user_annotation", False, 0, 1000, 0, 1),
        E("prefill", "user_annotation", False, 5, 700, 0, 1),
        E("moe", "user_annotation", False, 8, 500, 0, 1),
        E("moe.experts", "user_annotation", False, 9, 100, 0, 1),
        E("aten::_grouped_mm", "cpu_op", False, 10, 18, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 12, 14, 7, 99),
        *(shared if with_span else []),
        E("aten::mm", "cpu_op", False, 120, 130, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 122, 124, 8, 99),
        E("aten::mul", "cpu_op", False, 140, 150, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 142, 144, 9, 99),
        E("moe.combine", "user_annotation", False, 200, 300, 0, 1),
        E("aten::index_select", "cpu_op", False, 210, 220, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 212, 214, 10, 99),
        E("aten::copy_", "cpu_op", False, 705, 990, 0, 1),
        E("cudaMemcpyAsync", "cuda_runtime", False, 710, 720, 11, 99),
        E("cudaStreamSynchronize", "cuda_runtime", False, 730, 990, 0, 99),
        E("cutlass_grouped_gemm", "kernel", True, 300, 450, 7),
        E("nvjet_tst_gemm", "kernel", True, 450, 500, 8),
        E("elementwise_kernel", "kernel", True, 500, 510, 9),
        E("index_select_kernel", "kernel", True, 510, 550, 10),
        E("Memcpy DtoH", "gpu_memcpy", True, 900, 950, 11),
    ]
    t = tr.reduce(events, "portbench.window", prefills=1)
    return runner.TraceContext(t, t, {"flop": 1e6, "matmul_flop": 4e5})


def test_shared_expert_share_reads_the_shared_expert_span():
    reader = spec.metric_reader("moe_shared_expert_share.prefill")
    # the shared expert's GEMM and gate (50 + 10) of 300 device ns
    assert reader.read(_shared_expert_ctx()) == pytest.approx(60 / 300)
    assert reader.read(_shared_expert_ctx(with_span=False)) is None
    routing = spec.metric_reader("moe_routing_share.prefill")
    assert routing.read(_shared_expert_ctx()) == pytest.approx(40 / 300)
