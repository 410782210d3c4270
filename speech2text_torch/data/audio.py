"""Host-side audio IO and waveform-domain transforms (the port's copy of
speech2text_tpu/data/audio.py).

WAV IO is stdlib `wave` + numpy; speed perturbation is scipy's polyphase
resampler, so a speed-perturbed waveform equals the JAX package's bit for
bit: `speed s` shortens a waveform by factor s while keeping the sample
rate nominal.
"""

from __future__ import annotations

import wave
from fractions import Fraction

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file → (float32 waveform in [-1, 1], sample_rate).

    Matches torchaudio.load normalization (int16 / 32768).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        nch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        pcm = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw} in {path}")
    if nch > 1:
        pcm = pcm.reshape(-1, nch).mean(axis=1)
    return pcm, sr


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = 16000) -> None:
    """Write float32 [-1,1] waveform as 16-bit PCM WAV (for test fixtures)."""
    data = np.clip(pcm, -1.0, 1.0)
    data = np.round(data * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(data.tobytes())


def speed_perturb(pcm: np.ndarray, speed: float) -> np.ndarray:
    """sox-`speed`-style perturbation: resample by 1/speed, keep nominal rate.

    speed > 1 → shorter/faster, speed < 1 → longer/slower
    (reference data_augmentation.py:121-147 samples speed ∈ [0.9, 1.1]).
    """
    if abs(speed - 1.0) < 1e-6:
        return pcm
    frac = Fraction(speed).limit_denominator(100)
    # new_len ≈ len / speed: upsample by denominator, downsample by numerator.
    return resample_poly(pcm, frac.denominator, frac.numerator).astype(np.float32)

