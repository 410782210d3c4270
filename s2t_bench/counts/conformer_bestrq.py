"""Forward FLOPs of BEST-RQ pretraining with a relative-position Conformer
(Chiu et al. 2022, arXiv:2202.01855): the convolutional subsampling by
4, the blocks with their relative term, the encoder's output Dense, the
logits layer and, outside the gradient, the quantizer's products. The
counts module of the configurations that name "conformer_bestrq"
(counts/__init__.py): `step_flops` and `b2_calls`.

Per block, on T frames of width D with feed-forward F, H heads and a
depthwise kernel of K: two feed-forwards (2·2·D·F a frame each), the
q, k, v and output projections (2·4·D² a frame), the conv module's
pointwise pair and depthwise conv (2·(2·D² + D²) + 2·K·D a frame), the
scores' content term and the weighted sum (2·2·T²·D), the positional
term over every offset (2·T·(2T − 1)·D) and the positional Dense of the
(2T − 1)-row table, once a batch (2·(2T − 1)·D²). The attention's
recompute in the backward is not counted.
"""

from __future__ import annotations

from typing import Any, Dict

from .frames import fbank_frames
from .kernels import b2_calls as _speech_and_noise


def subsampled(frames: int) -> int:
    """Frames after two 3×3 convolutions of stride 2 without padding."""
    for _ in range(2):
        frames = (frames - 3) // 2 + 1
    return frames


def subsampling_flops(frames: int, feats: int, D: int) -> float:
    """Per utterance: Conv 1 → D, Conv D → D (3×3, stride 2), the Dense
    of the flattened (feature, channel) axes to D."""
    t1, f1 = (frames - 3) // 2 + 1, (feats - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    return (2 * 9 * D * t1 * f1 + 2 * 9 * D * D * t2 * f2
            + 2 * f2 * D * D * t2)


def block_flops(T: int, D: int, F: int, K: int) -> float:
    """One block on one utterance of T frames (the positional Dense is
    per batch: `pos_dense_flops`)."""
    per_frame = 2 * 2 * 2 * D * F + 2 * 4 * D * D + 2 * 3 * D * D \
        + 2 * K * D
    return T * per_frame + 2 * 2 * T * T * D + 2 * T * (2 * T - 1) * D


def pos_dense_flops(T: int, D: int) -> float:
    return 2.0 * (2 * T - 1) * D * D


def quantizer_flops(frames: int, config: Dict[str, Any]) -> float:
    """The labels of one utterance of `frames` feature frames: the
    projection of the stacked frames and every codebook's products, per
    label frame."""
    brq = config["ssl"]["best_rq"]
    s = brq.get("stack_size", 4)
    feats = config["encoder"]["config"].get("feats_dim", 80)
    cd = brq.get("codebook_dim", 16)
    books = brq.get("num_codebooks", 16) * brq.get("codebook_size", 8192)
    return (frames // s) * (2 * s * feats * cd + 2 * cd * books)


def step_flops(config: Dict[str, Any], batch: int, pcm_len: int,
               label_len: int) -> float:
    """Model FLOPs of one training step: 3× the trained forward, plus the
    quantizer's once. `label_len` is not read: pretraining has no
    labels."""
    task, enc = config["task"]["type"], config["encoder"]
    if task != "SSL" or enc["model"] != "Conformer":
        raise ValueError(f"no FLOP count for task {task} with "
                         f"{enc['model']}")
    c = enc["config"]
    D, F, L = c["input_dim"], c["ffn_dim"], c["num_layers"]
    frames = fbank_frames(pcm_len)
    T = subsampled(frames)
    brq = config["ssl"]["best_rq"]
    heads = brq.get("num_codebooks", 16) * brq.get("codebook_size", 8192)
    out = c.get("output_dim", D)
    per_utt = (subsampling_flops(frames, c.get("feats_dim", 80), D)
               + L * block_flops(T, D, F, c["depthwise_conv_kernel_size"])
               + T * 2 * D * out + T * 2 * out * heads)
    trained = batch * per_utt + L * pos_dense_flops(T, D)
    return 3.0 * trained + batch * quantizer_flops(frames, config)


def b2_calls(config: Dict[str, Any], batch: int, pcm_len: int,
             noise_len: int) -> list:
    """(B, N) of each B2 call of a step's featurizes: the raw view, then
    the augmented view and, with mix_feats, the noise batch."""
    return [(batch, pcm_len)] + _speech_and_noise(config, batch, pcm_len,
                                                  noise_len)
