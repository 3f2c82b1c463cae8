"""The work functions against counts made by hand at small shapes."""
import pytest

from portbench.lib import peaks, spec


def test_kernel_work_by_hand():
    # 4 queries, 4 keys, causal: 1 + 2 + 3 + 4 kept pairs, 4 d flop each
    assert peaks.flash_work(1, 4, 4, 2) == 4 * 2 * 10
    assert peaks.flash_work(3, 2, 5, 8) == 4 * 8 * 3 * (4 + 5)
    # b 1, h 1, s 4, chunk 2: 2 chunks of q (q + 1) (n + p) + 4 q n p
    assert peaks.ssd_work(1, 1, 4, 3, 5, 2) == 2 * (2 * 3 * 8 + 4 * 2 * 5 * 3)
    assert peaks.nbytes(((2, 3), "bfloat16"), ((4,), "float32")) == 12 + 16
    assert peaks.bound(3.35e12, 1.0) == 1.0
    assert peaks.bound(0.0, 989e12) == 1.0


def test_mixtral_work_by_hand():
    cfg = spec.config_parts("mixtral-8x22b")[1]
    w = cfg.work(cfg.smoke_dims(), batch=2, seq=32)
    t = 64
    # q and o 64 x 64, k and v 64 x 16, router 64 x 8, two experts of
    # 3 x 64 x 96 a token
    layer = 2 * t * (2 * 64 * 64 + 2 * 64 * 16 + 64 * 8 + 2 * 3 * 64 * 96)
    assert w["matmul_flop"] == 2 * layer + 2 * 2 * 64 * 256
    flash_flop = 4 * 8 * (2 * 8) * (32 * 33 // 2)
    # float32 smoke: q and the output at 16 (batch, head) pairs, k and v at 4
    flash_bytes = 4 * (2 * 16 * 32 * 8 + 2 * 4 * 32 * 8)
    assert w["flash"] == [(flash_flop, flash_bytes)] * 2
    assert w["flop"] == w["matmul_flop"] + 2 * flash_flop
    assert "ssd" not in w


def test_mixtral_published_work():
    doc, cfg, _ = spec.config_parts("mixtral-8x22b")
    w = cfg.work(cfg.dims(doc), batch=2, seq=8192)
    # 88.1M attention, 49K router and 2 x 302.0M expert parameters a token
    # in each of 8 layers, 16384 tokens; the head at 2 positions
    per_token = 88_080_384 + 49_152 + 2 * 301_989_888
    assert w["matmul_flop"] == pytest.approx(
        2 * 16384 * 8 * per_token + 2 * 2 * 6144 * 32768)
    assert len(w["flash"]) == 8
    assert w["flash"][0][0] == 4 * 128 * 96 * (8192 * 8193 // 2)


def test_mamba2_work_by_hand():
    cfg = spec.config_parts("mamba2-2.7b")[1]
    d = cfg.smoke_dims()
    w = cfg.work(d, batch=2, seq=32)
    t = 64
    # in_proj 64 x (2*128 + 2*32 + 8) and out_proj 128 x 64, per token
    layer = 2 * t * (64 * 328 + 128 * 64)
    assert w["matmul_flop"] == 3 * layer + 2 * 2 * 64 * 250
    ssd_flop = 2 * 8 * 2 * (16 * 17 * 48 + 4 * 16 * 32 * 16)
    # float32 smoke: x, dt, A, B and C, y, the final state
    ssd_bytes = 4 * (2 * 8 * 32 * 16 + 2 * 8 * 32 + 8 + 2 * (2 * 32 * 32)
                     + 2 * 8 * 32 * 16 + 2 * 8 * 16 * 32)
    assert w["ssd"] == [(ssd_flop, ssd_bytes)] * 3
    assert w["flop"] == w["matmul_flop"] + 3 * ssd_flop
    assert "flash" not in w


def test_mamba2_published_work():
    doc, cfg, _ = spec.config_parts("mamba2-2.7b")
    d = cfg.dims(doc)
    assert (d["ssm_heads"], d["state"], d["chunk"]) == (80, 128, 256)
    w = cfg.work(d, batch=16, seq=4096)
    # in_proj 2560 x 10576 and out_proj 5120 x 2560: 39.2M a layer
    assert w["matmul_flop"] == pytest.approx(
        2 * 65536 * 64 * (2560 * 10576 + 5120 * 2560) + 2 * 16 * 2560 * 50277)
    assert len(w["ssd"]) == 64
