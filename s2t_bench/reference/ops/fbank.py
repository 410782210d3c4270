"""Kaldi log-mel fbank, plain PyTorch only (the port's
speech2text_torch/ops/fbank.py without kernel B2 and without dither):
framing (snip_edges or centred with reflection), DC removal,
pre-emphasis, window, the DFT as two matrix products, mel projection and
log, in f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's log floor


def frame_signal(pcm: torch.Tensor, max_frames: int, frame_length: int,
                 frame_shift: int, snip_edges: bool = True) -> torch.Tensor:
    """(B, N) pcm → (B, max_frames, frame_length) frames by index.

    snip_edges: frame t starts at sample t·shift (indices past the end
    are clamped: those frames are masked by the caller). Otherwise frames
    are centred on t·shift + shift//2 with reflection at both edges."""
    B, N = pcm.shape
    starts = torch.arange(max_frames, device=pcm.device) * frame_shift
    if not snip_edges:
        starts = starts + frame_shift // 2 - frame_length // 2
    idx = starts[:, None] + torch.arange(frame_length, device=pcm.device)
    if not snip_edges:
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= N, 2 * N - 1 - idx, idx)
    idx = idx.clamp(0, N - 1)
    return pcm[:, idx]


def fbank_plain(pcm: torch.Tensor, window: torch.Tensor,
                dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                banks: torch.Tensor, max_frames: int, frame_length: int = 400,
                frame_shift: int = 160, preemph: float = 0.97,
                remove_dc: bool = True,
                snip_edges: bool = True) -> torch.Tensor:
    """Plain PyTorch fbank in f32: (B, N) → (B, max_frames, n_mels)."""
    frames = frame_signal(pcm.float(), max_frames, frame_length,
                          frame_shift, snip_edges)
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemph > 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemph * prev
    frames = frames * window
    re = frames @ dft_cos
    im = frames @ dft_sin
    power = re.square() + im.square()
    mel = power @ banks.T
    return torch.log(torch.clamp(mel, min=EPSILON))


def dft_matrices(frame_length: int, n_fft: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The (frame_length, n_fft//2+1) cos/sin matrices of the n_fft-point
    DFT of a frame zero-padded to n_fft, built in float64, stored as f32."""
    ang = -2.0 * np.pi * np.outer(np.arange(frame_length),
                                  np.arange(n_fft // 2 + 1)) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def max_frames_of(n_samples: int, frame_length: int, frame_shift: int,
                  snip_edges: bool) -> int:
    """The frames the framing takes from `n_samples` (kaldi's count:
    whole frames with snip_edges, else one per shift, rounded)."""
    if snip_edges:
        return 1 + (n_samples - frame_length) // frame_shift \
            if n_samples >= frame_length else 0
    return (n_samples + frame_shift // 2) // frame_shift


def fbank(pcm: torch.Tensor, window: torch.Tensor, dft_cos: torch.Tensor,
          dft_sin: torch.Tensor, banks: torch.Tensor, max_frames: int,
          frame_length: int = 400, frame_shift: int = 160,
          preemph: float = 0.97, remove_dc: bool = True,
          snip_edges: bool = True) -> torch.Tensor:
    """(B, N) pcm → (B, max_frames, n_mels) f32 log-mel features."""
    return fbank_plain(pcm, window, dft_cos, dft_sin, banks, max_frames,
                       frame_length, frame_shift, float(preemph),
                       bool(remove_dc), bool(snip_edges))
