"""The least time of kernels B1 (Zipformer attention weights) and B2
(fbank) on one H100, from the shapes of their inputs and outputs: each
byte read once and written once at the HBM rate, the operations at the
peak rate of their precision; the larger of the two bounds the kernel."""

from __future__ import annotations

import math

from .frames import fbank_frames
from .peaks import FLOPS, HBM_BYTES_PER_S


def b1_least_s(B: int, T: int, H: int, qd: int, pd: int,
               dtype_bytes: int = 2) -> float:
    """Weights (B, H, T, T) from q, k (B, T, H, qd), qp (B, T, H, pd),
    p (2T−1, H, pd) and a (B, T, T) bool mask: 2·B·H·T²·(qd+pd) operations
    on tensor cores (bf16) or in f32."""
    nbytes = (dtype_bytes * (2 * B * T * H * qd + B * T * H * pd
                             + (2 * T - 1) * H * pd)
              + B * T * T                       # mask
              + dtype_bytes * B * H * T * T)    # weights out
    ops = 2.0 * B * H * T * T * (qd + pd)
    peak = FLOPS["bfloat16"] if dtype_bytes == 2 else FLOPS["float32"]
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def b2_least_s(B: int, n_samples: int, n_mels: int = 80,
               n_fft: int = 512, frame_length: int = 400,
               frame_shift: int = 160, dither: bool = False) -> float:
    """Log-mel features (B, frames, n_mels) f32 from f32 PCM (B, N), plus
    a (B, frames, frame_length) f32 noise operand under dither; per frame
    the operations of one n_fft-point real FFT (5·(n/2)·log2(n/2) for the
    half-size complex FFT), the power of the n/2+1 bins (3 each) and the
    mel products over each filter's non-zero bins (every bin lies in at
    most two triangular filters: 2·2 per bin), in f32."""
    frames = fbank_frames(n_samples, frame_length, frame_shift)
    nbytes = 4 * (B * n_samples + B * frames * n_mels)
    if dither:
        nbytes += 4 * B * frames * frame_length
    nc = n_fft // 2
    ops = B * frames * (5.0 * nc * math.log2(nc) + 7.0 * (nc + 1))
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS["float32"])


def b1_calls(enc: dict, batch: int, frames: int) -> list:
    """(B, T, H) of each layer's B1 call on a batch of `frames` fbank
    frames (the Zipformer2's stacks, one call per layer)."""
    from .zipformer import embed_frames, stack_frames
    Ts = stack_frames(embed_frames(frames), enc["downsampling_factor"])
    return [(batch, T, H) for T, H, n in zip(Ts, enc["num_heads"],
                                             enc["num_encoder_layers"])
            for _ in range(n)]


def b2_calls(config: dict, batch: int, pcm_len: int, noise_len: int
             ) -> list:
    """(B, N) of each B2 call of a training step's featurize: the speech
    batch and, with mix_feats on, the noise batch."""
    aug = (config.get("dataset") or {}).get("data_aug_config") or {}
    calls = [(batch, pcm_len)]
    if aug.get("use_mix_feats"):
        calls.append((batch, noise_len))
    return calls
