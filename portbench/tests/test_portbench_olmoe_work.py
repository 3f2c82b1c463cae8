"""olmoe-1b-7b's work function against counts made by hand: at its smoke
sizes, and at the published sizes of its cell (2 x 4096); the reader of the
QK-norm's share on a hand-made trace."""
import pytest

from portbench.lib import runner, spec
from portbench.lib import trace as tr

E = tr.Event


def test_olmoe_work_by_hand():
    cfg = spec.config_parts("olmoe-1b-7b")[1]
    w = cfg.work(cfg.smoke_dims(), batch=2, seq=32)
    t = 64
    # a layer, per token: q and o 64 x 64 each, k and v 64 x 64 each, the
    # router 64 x 8, 4 experts of three 64 x 48 products
    layer = 2 * 64 * 64 + 2 * 64 * 64 + 64 * 8 + 4 * 3 * 64 * 48
    assert layer == 53_760
    assert w["matmul_flop"] == 2 * t * 2 * layer + 2 * 2 * 64 * 250
    # 4 heads of 16 at batch 2: 8 (batch, head) pairs; float32 smoke: q, k,
    # v and the output, each 8 x 32 x 16
    flash = (4 * 16 * 8 * (32 * 33 // 2), 4 * 4 * 8 * 32 * 16)
    assert w["flash"] == [flash] * 2
    assert w["flop"] == w["matmul_flop"] + 2 * flash[0]


def test_olmoe_published_work():
    doc, cfg, _ = spec.config_parts("olmoe-1b-7b")
    d = cfg.dims(doc)
    assert (d["layers"], d["heads"], d["head_dim"], d["vocab"]) == (16, 16, 128, 50304)
    assert (d["experts"], d["top_k"], d["d_expert"]) == (64, 8, 1024)
    assert d["capacity_factor"] * d["top_k"] == d["experts"]
    assert d["norm_topk_prob"] is False
    w = cfg.work(d, batch=2, seq=4096)
    # a layer, per token: 16.8M multiply-adds of q/k/v/o, 131,072 of the
    # router, 8 experts of 6.29M; the head at 2 positions
    assert 16 * (16_777_216 + 131_072 + 50_331_648) == 1_075_838_976
    assert w["matmul_flop"] == 2 * 8192 * 1_075_838_976 + 2 * 2 * 2048 * 50304
    assert w["flash"] == [(4 * 128 * 32 * (4096 * 4097 // 2),
                           4 * 32 * 4096 * 128 * 2)] * 16
    assert w["flop"] == 19_826_517_999_616
    assert w["flop"] == pytest.approx(1.98e13, rel=2e-3)


def _qk_ctx(with_span=True):
    """A matmul launched in ``attn``, two norm kernels in ``attn.qk_norm``,
    a kernel in ``moe.router`` and the logits' copy outside every span."""
    qk = [E("attn.qk_norm", "user_annotation", False, 30, 60, 0, 1)]
    events = [
        E("portbench.window", "user_annotation", False, 0, 1000, 0, 1),
        E("prefill", "user_annotation", False, 5, 700, 0, 1),
        E("attn", "user_annotation", False, 8, 500, 0, 1),
        *(qk if with_span else []),
        E("aten::mm", "cpu_op", False, 10, 18, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 12, 14, 7, 99),
        E("aten::mul", "cpu_op", False, 35, 40, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 36, 38, 8, 99),
        E("aten::rsqrt", "cpu_op", False, 45, 55, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 46, 48, 9, 99),
        E("moe.router", "user_annotation", False, 510, 600, 0, 1),
        E("aten::softmax", "cpu_op", False, 515, 530, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 520, 522, 10, 99),
        E("aten::copy_", "cpu_op", False, 705, 990, 0, 1),
        E("cudaMemcpyAsync", "cuda_runtime", False, 710, 720, 11, 99),
        E("cudaStreamSynchronize", "cuda_runtime", False, 730, 990, 0, 99),
        E("nvjet_tst_gemm", "kernel", True, 100, 250, 7),
        E("elementwise_kernel", "kernel", True, 250, 280, 8),
        E("elementwise_kernel", "kernel", True, 280, 300, 9),
        E("softmax_kernel", "kernel", True, 300, 400, 10),
        E("Memcpy DtoH", "gpu_memcpy", True, 900, 950, 11),
    ]
    t = tr.reduce(events, "portbench.window", prefills=1)
    return runner.TraceContext(t, t, {"flop": 1e6, "matmul_flop": 4e5})


def test_qk_norm_share_reads_the_qk_norm_span():
    reader = spec.metric_reader("qk_norm_share.prefill")
    # the two norm kernels (30 + 20) of 350 device ns
    assert reader.read(_qk_ctx()) == pytest.approx(50 / 350)
    assert reader.read(_qk_ctx(with_span=False)) is None
