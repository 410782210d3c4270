"""Batched on-device data augmentation (port of
speech2text_tpu/data/augment.py).

Each transform is split in two:
  - a sampler, `sample_*`, that draws the transform's random values from an
    explicit `torch.Generator` on the tensor's device (no host read-back):
    starts, widths, SNRs, circular offsets and the per-utterance `apply`
    mask;
  - a deterministic apply function that takes those draws and computes
    exactly the JAX function's formula, so that the JAX package's draws
    give its output.

- spec_augment: 2 time masks (≤50 frames) + 2 freq masks (≤10 bins),
  zeroed; positions independent per utterance.
- mix_feats: log-mel-domain energy-scaled mixing of a noise feature matrix
  at a random SNR from a fixed list.
- add_noise: waveform-domain SNR mixing; the noise clip is circularly
  shifted (random offset) to cover the utterance, gain-scaled to the
  target SNR, clipped to [-1, 1].
Speed perturbation stays on the host (data/audio.py:speed_perturb).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

Draws = Dict[str, torch.Tensor]


def _rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def sample_apply(batch_size: int, p: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """(B,) bool: each utterance augmented with probability p."""
    return _rand((batch_size,), generator, device) < p


def sample_offsets(lens: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """(B,) int64 uniform in [0, max(lens, 1))."""
    n = torch.clamp(lens.to(torch.int64), min=1)
    u = torch.rand(lens.shape, generator=generator, device=lens.device,
                   dtype=torch.float64)
    return torch.minimum((u * n).to(torch.int64), n - 1)


# ------------------------------------------------------------ spec_augment
def sample_spec_augment(feat_lens: torch.Tensor, num_bins: int,
                        generator: torch.Generator,
                        num_time_masks: int = 2, time_mask_max: int = 50,
                        num_freq_masks: int = 2, freq_mask_max: int = 10
                        ) -> Draws:
    """time widths in [0, time_mask_max], time starts in
    [0, max(len - width, 1)), freq widths in [0, freq_mask_max], freq
    starts in [0, max(D - freq_mask_max, 1)); each (B, masks) int64."""
    B, dev = feat_lens.shape[0], feat_lens.device
    tw = torch.randint(0, time_mask_max + 1, (B, num_time_masks),
                       generator=generator, device=dev)
    max_start = torch.clamp(feat_lens.to(torch.int64)[:, None] - tw, min=1)
    ts = (_rand((B, num_time_masks), generator, dev)
          * max_start.float()).to(torch.int64)
    fw = torch.randint(0, freq_mask_max + 1, (B, num_freq_masks),
                       generator=generator, device=dev)
    fs = torch.randint(0, max(num_bins - freq_mask_max, 1),
                       (B, num_freq_masks), generator=generator, device=dev)
    return {"time_start": ts, "time_width": tw, "freq_start": fs,
            "freq_width": fw}


def spec_augment(feats: torch.Tensor, draws: Draws,
                 apply: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero the drawn time and frequency bands of feats (B, T, D)."""
    _, T, D = feats.shape
    dev = feats.device
    t_idx = torch.arange(T, device=dev)[None, None, :]
    f_idx = torch.arange(D, device=dev)[None, None, :]
    ts, tw = draws["time_start"][..., None], draws["time_width"][..., None]
    fs, fw = draws["freq_start"][..., None], draws["freq_width"][..., None]
    time_masked = ((t_idx >= ts) & (t_idx < ts + tw)).any(dim=1)   # (B, T)
    freq_masked = ((f_idx >= fs) & (f_idx < fs + fw)).any(dim=1)   # (B, D)
    kill = time_masked[:, :, None] | freq_masked[:, None, :]
    if apply is not None:
        kill = kill & apply[:, None, None]
    return torch.where(kill, torch.zeros((), dtype=feats.dtype, device=dev),
                       feats)


# --------------------------------------------------------------- mix_feats
def sample_mix_feats(noise_feat_lens: torch.Tensor,
                     generator: torch.Generator, p: float,
                     snrs: Sequence[float] = (10.0, 20.0)) -> Draws:
    """apply (B,) bool, snr (B,) f32 from `snrs`, offset (B,) int64 into
    each noise feature matrix."""
    B, dev = noise_feat_lens.shape[0], noise_feat_lens.device
    apply = sample_apply(B, p, generator, dev)
    pick = torch.randint(0, len(snrs), (B,), generator=generator,
                         device=dev)
    # chosen on the device: a table copied from the host would wait
    snr = torch.zeros((B,), dtype=torch.float32, device=dev)
    for i, v in enumerate(snrs):
        snr = torch.where(pick == i, float(v), snr)
    return {"apply": apply, "snr": snr,
            "offset": sample_offsets(noise_feat_lens, generator)}


def _circular(noise: torch.Tensor, noise_lens: torch.Tensor,
              offset: torch.Tensor, n: int) -> torch.Tensor:
    """noise (B, Nn, ...) read circularly from `offset` over n steps."""
    t = torch.arange(n, device=noise.device)
    nl = torch.clamp(noise_lens.to(torch.int64), min=1)
    idx = (offset.to(torch.int64)[:, None] + t[None, :]) % nl[:, None]
    if noise.ndim == 3:
        idx = idx[:, :, None].expand(-1, -1, noise.shape[2])
    return torch.gather(noise, 1, idx)


def mix_feats(feats: torch.Tensor, feat_lens: torch.Tensor,
              noise_feats: torch.Tensor, noise_lens: torch.Tensor,
              draws: Draws) -> torch.Tensor:
    """feats (B, T, D) log-mel mixed with noise_feats (B, Tn, D) at the
    drawn SNR, where `apply`; noise_lens are noise frame counts."""
    B, T, D = feats.shape
    noise = _circular(noise_feats, noise_lens, draws["offset"], T)
    t = torch.arange(T, device=feats.device)
    valid = (t[None, :] < feat_lens[:, None]).to(torch.float32)
    lin_s = torch.exp(feats)
    lin_n = torch.exp(noise)
    n_valid = torch.clamp(valid.sum(dim=1) * D, min=1.0)
    e_s = (lin_s * valid[..., None]).sum(dim=(1, 2)) / n_valid
    e_n = (lin_n * valid[..., None]).sum(dim=(1, 2)) / n_valid
    factor = e_s / (e_n * torch.pow(10.0, draws["snr"] / 10.0) + 1e-10)
    mixed = torch.log(torch.clamp(lin_s + factor[:, None, None] * lin_n,
                                  min=1.1920929e-07))
    return torch.where(draws["apply"][:, None, None], mixed, feats)


# --------------------------------------------------------------- add_noise
def sample_add_noise(noise_lens: torch.Tensor, generator: torch.Generator,
                     p: float, min_snr_db: float = 10.0,
                     max_snr_db: float = 50.0) -> Draws:
    """apply (B,) bool, snr (B,) f32 uniform in [min_snr_db, max_snr_db),
    offset (B,) int64 into each noise clip."""
    B, dev = noise_lens.shape[0], noise_lens.device
    apply = sample_apply(B, p, generator, dev)
    snr = min_snr_db + (max_snr_db - min_snr_db) * _rand((B,), generator,
                                                         dev)
    return {"apply": apply, "snr": snr,
            "offset": sample_offsets(noise_lens, generator)}


def add_noise(pcm: torch.Tensor, pcm_lens: torch.Tensor,
              noise_pcm: torch.Tensor, noise_lens: torch.Tensor,
              draws: Draws) -> torch.Tensor:
    """pcm (B, N) f32 in [-1, 1] plus noise_pcm (B, Nn) at the drawn SNR,
    where `apply`."""
    B, N = pcm.shape
    noise = _circular(noise_pcm, noise_lens, draws["offset"], N)
    t = torch.arange(N, device=pcm.device)
    valid = (t[None, :] < pcm_lens[:, None]).to(torch.float32)
    n_valid = torch.clamp(valid.sum(dim=1), min=1.0)
    p_s = (pcm.square() * valid).sum(dim=1) / n_valid
    p_n = (noise.square() * valid).sum(dim=1) / n_valid
    gain = torch.sqrt(p_s / (p_n * torch.pow(10.0, draws["snr"] / 10.0)
                             + 1e-12))
    out = torch.clamp(pcm + gain[:, None] * noise * valid, -1.0, 1.0)
    return torch.where(draws["apply"][:, None], out, pcm)
