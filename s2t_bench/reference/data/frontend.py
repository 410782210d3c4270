"""Kaldi-compatible log-mel fbank frontend (port of
speech2text_tpu/data/frontend.py).

The window, mel banks and DFT matrices are built in float64 with numpy
and stored as f32, exactly as the JAX package builds them; `Fbank` keeps
them as buffers and hands them to ops/fbank.py, which runs the CUDA
kernel on a CUDA tensor and the plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.fbank import dft_matrices, fbank, max_frames_of


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    sample_rate: int = 16000
    dither: float = 0.0  # read only to refuse it (no dither here)
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 → offset from nyquist
    snip_edges: bool = True
    window_type: str = "povey"

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        return 1 << (self.frame_length - 1).bit_length()  # next pow2

    def num_frames(self, num_samples: int) -> int:
        return max_frames_of(num_samples, self.frame_length,
                             self.frame_shift, self.snip_edges)


def feat_lengths(cfg: FbankConfig,
                 sample_lengths: torch.Tensor) -> torch.Tensor:
    """Per-utterance frame counts from sample counts (int32)."""
    n = sample_lengths.to(torch.int32)
    if cfg.snip_edges:
        return torch.clamp(
            1 + torch.div(n - cfg.frame_length, cfg.frame_shift,
                          rounding_mode="floor"), min=0).to(torch.int32)
    return torch.div(n + cfg.frame_shift // 2, cfg.frame_shift,
                     rounding_mode="floor").to(torch.int32)


def dequant_pcm(pcm: torch.Tensor) -> torch.Tensor:
    """int16 wire format → f32 waveform in [-1, 1)."""
    if pcm.dtype == torch.int16:
        return pcm.float() * (1.0 / 32768.0)
    return pcm.float()


def povey_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))
    return np.power(hann, 0.85).astype(np.float32)


def make_window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        return povey_window(n)
    if cfg.window_type == "hanning":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))).astype(
            np.float32)
    if cfg.window_type == "hamming":
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(
            np.float32)
    if cfg.window_type == "rectangular":
        return np.ones(n, np.float32)
    raise ValueError(f"unknown window {cfg.window_type}")


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def make_mel_banks(cfg: FbankConfig) -> np.ndarray:
    """(num_mel_bins, n_fft//2 + 1) kaldi-style triangular mel banks; the
    nyquist bin gets weight 0."""
    n_fft = cfg.padded_window_size
    num_fft_bins = n_fft // 2
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low, mel_high = mel_scale(cfg.low_freq), mel_scale(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_freqs = np.arange(num_fft_bins, dtype=np.float64) * (
        cfg.sample_rate / n_fft)
    mel_f = mel_scale(fft_freqs)
    banks = np.zeros((cfg.num_mel_bins, num_fft_bins + 1), np.float64)
    for b in range(cfg.num_mel_bins):
        left = mel_low + b * delta
        center = left + delta
        right = center + delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        banks[b, :num_fft_bins] = np.clip(np.minimum(up, down), 0.0, None)
    return banks.astype(np.float32)


def make_dft_matrices(cfg: FbankConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT as two (frame_length, n_fft//2+1) matrices; the zero
    padding to n_fft is folded in (only the first frame_length rows)."""
    return dft_matrices(cfg.frame_length, cfg.padded_window_size)


class Fbank(nn.Module):
    """Batched fbank extractor.

    forward(pcm (B, N) f32 in [-1, 1], sample_lengths (B,)) →
      (feats (B, T_max, num_mel_bins) f32, feat_lengths (B,) int32).
    Frames past an utterance's own frame count hold features of pad
    samples; consumers mask them with the lengths."""

    def __init__(self, cfg: FbankConfig | None = None, **kwargs):
        super().__init__()
        self.cfg = cfg or FbankConfig(**kwargs)
        dft_cos, dft_sin = make_dft_matrices(self.cfg)
        for name, arr in (("window", make_window(self.cfg)),
                          ("banks", make_mel_banks(self.cfg)),
                          ("dft_cos", dft_cos), ("dft_sin", dft_sin)):
            self.register_buffer(name, torch.from_numpy(arr),
                                 persistent=False)

    def forward(self, pcm: torch.Tensor, sample_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        max_frames = cfg.num_frames(int(pcm.shape[-1]))
        if max_frames == 0:
            # shorter than one frame: no frames, and no zero-size launch
            feats = pcm.new_zeros((pcm.shape[0], 0, cfg.num_mel_bins),
                                  dtype=torch.float32)
        else:
            feats = fbank(pcm, self.window, self.dft_cos, self.dft_sin,
                          self.banks, max_frames,
                          frame_length=cfg.frame_length,
                          frame_shift=cfg.frame_shift,
                          preemph=cfg.preemphasis,
                          remove_dc=cfg.remove_dc_offset,
                          snip_edges=cfg.snip_edges)
        lens = feat_lengths(cfg, torch.as_tensor(sample_lengths,
                                                 device=pcm.device))
        return feats, lens


class FeatType(Enum):
    fbank = "fbank"
    lhotes_fbank = "lhotes_fbank"
    torchscript_fbank = "torchscript_fbank"


def FrontendSetup(feat_type: str, config: dict | None = None):
    config = dict(config or {})
    ft = FeatType[feat_type]
    kw = {}
    if "num_mel_bins" in config:
        kw["num_mel_bins"] = config["num_mel_bins"]
    if "snip_edges" in config:
        kw["snip_edges"] = bool(config["snip_edges"])
    if "dither" in config:
        kw["dither"] = float(config["dither"])
    if ft == FeatType.fbank:
        kw.setdefault("snip_edges", True)
        if "frame_length" in config:
            kw["frame_length_ms"] = float(config["frame_length"])
        if "frame_shift" in config:
            kw["frame_shift_ms"] = float(config["frame_shift"])
        if "samplerate" in config:
            kw["sample_rate"] = int(config["samplerate"])
    return Fbank(FbankConfig(**kw))
