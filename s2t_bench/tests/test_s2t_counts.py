"""The FLOP and byte counters against hand counts at small shapes."""

import json

import pytest

from s2t_bench.cell import PACKAGE
from s2t_bench.counts import zipformer
from s2t_bench.counts.frames import fbank_frames
from s2t_bench.counts.kernels import (b1_calls, b1_least_s, b2_calls,
                                      b2_least_s)
from s2t_bench.counts.peaks import FLOPS, HBM_BYTES_PER_S, matmul_peak


def test_fbank_frames():
    assert fbank_frames(399) == 0
    assert fbank_frames(400) == 1
    assert fbank_frames(16000) == 98          # 1 + 15600 // 160


def test_b1_least_time():
    # B=1, T=2, H=1, qd=pd=1, bf16: q, k 2·2 + qp 2 + p 3 elements of 2
    # bytes = 18, mask 4, weights 4 of 2 bytes = 8 → 30 bytes;
    # operations 2·1·1·4·2 = 16
    assert b1_least_s(1, 2, 1, 1, 1) == pytest.approx(
        max(30 / HBM_BYTES_PER_S, 16 / FLOPS["bfloat16"]))
    # f32: 4-byte operands and weights → 36 + 16 + 4 = 56 bytes
    assert b1_least_s(1, 2, 1, 1, 1, 4) == pytest.approx(56 / HBM_BYTES_PER_S)


def test_b2_least_time():
    # B=2, 560 samples: 2 frames; bytes 4·(2·560 + 2·2·80) = 5760;
    # operations 2·2·(5·256·8 + 7·257) = 48156
    assert b2_least_s(2, 560) == pytest.approx(
        max(5760 / HBM_BYTES_PER_S, 48156 / FLOPS["float32"]))
    assert b2_least_s(2, 560, dither=True) == pytest.approx(
        (5760 + 4 * 2 * 2 * 400) / HBM_BYTES_PER_S)


def test_zipformer_layer_by_hand():
    # T=2, D=4, ff=4, H=1, qd=vd=pd=1, pos_dim=1, kernel=1
    per_frame = (2 * 4 * 3 + 4 * 4 * 3 + 4 * 4 * 4 + 4 * 4 * 5
                 + 2 * 4 * 9 + 2 * 3 * 4 + 8 * 4 + 2 * (64 + 8 + 32))
    squares = 2 * 4 * 2 + 4 * 4 + 2 * 4 * 3
    pos = 2 * 3
    assert zipformer.layer_flops(2, 4, 4, 1, 1, 1, 1, 1, 1) == \
        2 * per_frame + squares + pos


def test_zipformer_embed_by_hand():
    # 11 frames of 9 bins: conv1 9×7, conv2 4×3, conv3 2×1
    C = 32
    want = (2 * 9 * C * 9 * 7 + 2 * 9 * C * C * 4 * 3 + 2 * 9 * C * C * 2
            + 2 * 49 * C * 2 + 2 * 2 * C * 3 * C * 2 + 2 * 1 * C * 5 * 2)
    assert zipformer.embed_flops(11, 9, 5) == want
    assert zipformer.embed_frames(11) == 2


def test_step_flops_is_three_forwards():
    z = json.load(open(PACKAGE / "configs" / "zipformer_prnnt.json"))
    cfg = z["train_config"]
    assert zipformer.step_flops(cfg, 4, 48000, 16) == \
        3 * zipformer.rnnt_forward_flops(cfg, 4, 48000, 16)
    # the simple loss's product grows with the vocabulary: 2·T·(U+1)·V
    small = json.loads(json.dumps(cfg))
    small["joiner"]["output_dim"] = 128
    T = zipformer.output_frames(fbank_frames(48000), cfg["encoder"]["config"])
    D = cfg["joiner"]["input_dim"]
    grow = 4 * ((T + 17) * 2 * D + 2 * T * 17) * (4336 - 128)
    assert abs(zipformer.rnnt_forward_flops(cfg, 4, 48000, 16)
               - zipformer.rnnt_forward_flops(small, 4, 48000, 16)
               - grow) < 1e-3


def test_kernel_calls_of_the_flagship():
    z = json.load(open(PACKAGE / "configs" / "zipformer_prnnt.json"))
    cfg = z["train_config"]
    calls = b1_calls(cfg["encoder"]["config"], 8, 998)
    # 998 frames → 495 after the embed; stacks at 1, 2, 4, 8, 4, 2
    assert [c[1] for c in calls] == [495, 495, 248, 248, 124, 124, 62, 62,
                                     124, 124, 248, 248]
    assert [c[2] for c in calls][6:8] == [8, 8]
    assert b2_calls(cfg, 8, 1000, 700) == [(8, 1000), (8, 700)]


def test_peaks():
    assert matmul_peak("bfloat16", "highest") == 989e12
    assert matmul_peak("float32", "highest") == 67e12
    assert matmul_peak("float32", "high") == 495e12
