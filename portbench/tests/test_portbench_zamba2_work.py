"""zamba2-7b's work function against counts made by hand: at its smoke sizes,
and at the published sizes of its cell (2 x 4096); the reader of the shared
blocks' share on a hand-made trace."""
import pytest

from portbench.lib import peaks, runner, spec
from portbench.lib import trace as tr

E = tr.Event


def test_zamba2_work_by_hand():
    cfg = spec.config_parts("zamba2-7b")[1]
    w = cfg.work(cfg.smoke_dims(), batch=2, seq=32)
    t = 64
    # a Mamba2 layer: in_proj 64 x (2*128 + 2*2*16 + 8), out_proj 128 x 64
    mamba = 64 * 328 + 128 * 64
    # a shared-block call on 128 channels: q, k, v 128 x 128, o 128 x 64,
    # gate/up 64 x 192, LoRA 64 x 8 and 8 x 192, down 96 x 64, the
    # call's projection 64 x 64
    shared = 128 * 384 + 128 * 64 + 64 * 192 + 8 * (64 + 192) + 96 * 64 + 64 * 64
    assert (mamba, shared) == (29_184, 81_920)
    assert w["matmul_flop"] == 2 * t * (7 * mamba + 4 * shared) + 2 * 2 * 64 * 250
    # 4 heads of 32 at batch 2: 8 (batch, head) pairs; float32 smoke: q, k,
    # v and the output, each 8 x 32 x 32
    flash = (4 * 32 * 8 * (32 * 33 // 2), 4 * 4 * 8 * 32 * 32)
    assert w["flash"] == [flash] * 4
    ssd_flop = 2 * 8 * 2 * (16 * 17 * 32 + 4 * 16 * 16 * 16)
    assert w["ssd"][0][0] == ssd_flop and len(w["ssd"]) == 7
    assert w["flop"] == w["matmul_flop"] + 4 * flash[0] + 7 * ssd_flop


def test_zamba2_published_work():
    doc, cfg, _ = spec.config_parts("zamba2-7b")
    d = cfg.dims(doc)
    assert (d["layers"], d["ssm_heads"], d["groups"], d["state"]) == (81, 112, 2, 64)
    assert (d["heads"], d["head_dim"], d["rank"], d["d_ff"]) == (32, 224, 128, 14336)
    w = cfg.work(d, batch=2, seq=4096)
    # 81 Mamba2 layers of 78.4M and 13 shared-block calls of 350.9M
    # multiply-adds a token; the head at 2 positions
    assert 81 * 78_389_248 + 13 * 350_945_280 == 10_911_817_728
    assert w["matmul_flop"] == pytest.approx(
        2 * 8192 * 10_911_817_728 + 2 * 2 * 3584 * 32000, rel=1e-12)
    assert w["flash"] == [(4 * 224 * 64 * (4096 * 4097 // 2),
                           4 * 64 * 4096 * 224 * 2)] * 13
    assert len(w["ssd"]) == 81
    assert w["ssd"][0][0] == peaks.ssd_work(2, 112, 4096, 64, 64, 256)
    assert w["flop"] == pytest.approx(
        w["matmul_flop"] + 13 * w["flash"][0][0] + 81 * w["ssd"][0][0])


def _shared_ctx(with_shared=True):
    """A concat launched in ``shared`` itself, a matmul in ``shared.mlp``,
    an add in ``ssm`` and the logits' copy outside every span."""
    shared = [E("shared", "user_annotation", False, 8, 500, 0, 1),
              E("shared.mlp", "user_annotation", False, 20, 40, 0, 1)]
    events = [
        E("portbench.window", "user_annotation", False, 0, 1000, 0, 1),
        E("prefill", "user_annotation", False, 5, 700, 0, 1),
        *(shared if with_shared else []),
        E("aten::cat", "cpu_op", False, 10, 18, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 12, 14, 7, 99),
        E("aten::mm", "cpu_op", False, 21, 39, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 25, 27, 8, 99),
        E("ssm", "user_annotation", False, 510, 600, 0, 1),
        E("aten::add", "cpu_op", False, 515, 530, 0, 1),
        E("cudaLaunchKernel", "cuda_runtime", False, 520, 522, 9, 99),
        E("aten::copy_", "cpu_op", False, 705, 990, 0, 1),
        E("cudaMemcpyAsync", "cuda_runtime", False, 710, 720, 10, 99),
        E("cudaStreamSynchronize", "cuda_runtime", False, 730, 990, 0, 99),
        E("cat_kernel", "kernel", True, 100, 150, 7),
        E("nvjet_tst_gemm", "kernel", True, 150, 300, 8),
        E("elementwise_kernel", "kernel", True, 300, 400, 9),
        E("Memcpy DtoH", "gpu_memcpy", True, 900, 950, 10),
    ]
    t = tr.reduce(events, "portbench.window", prefills=1)
    return runner.TraceContext(t, t, {"flop": 1e6, "matmul_flop": 4e5})


def test_shared_block_share_reads_the_shared_spans():
    reader = spec.metric_reader("shared_block_share.prefill")
    # the concat and the matmul (50 + 150) of 350 device ns
    assert reader.read(_shared_ctx()) == pytest.approx(200 / 350)
    assert reader.read(_shared_ctx(with_shared=False)) is None
