"""Kaldi log-mel fbank: kernel B2's wrapper and its plain version.

`fbank` calls the custom op `speech2text_torch::fbank` (one node to
`torch.export`, shaped by its fake implementation), which dispatches on
the PCM's device: a CPU tensor takes `fbank_plain`, a CUDA tensor
launches csrc/fbank.cu or raises. The kernel takes the power spectrum by
an n_fft-point real FFT, which is the transform the DFT matrices hold
(n_fft a power of two from 128 to 2048: `FFT_SIZES`), and the mel
projection over each filter's run of non-zero bins (`mel_runs`). Both
framings of `frame_signal` (snip_edges, centred with reflection) run on
either route. `fbank_plain` mirrors
speech2text_tpu/data/frontend.py:_fbank_impl. Training-time dither is
Gaussian noise of scale `dither` added to each frame: `fbank` draws the
noise once from the caller's generator (or takes the caller's noise) and
hands the same tensor to the kernel or to `fbank_plain`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .build import (CudaKernel, on_device, ptr, ready, stream_handle,
                    use_kernel)

EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's log floor
FFT_SIZES = tuple(1 << i for i in range(7, 12))   # the kernel's 128 .. 2048
ENTRY = "fbank_forward"
KERNEL = CudaKernel("fbank", "fbank.cu", entries={
    ENTRY: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]})


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
                remove_dc: bool = True, snip_edges: bool = True,
                noise: torch.Tensor | None = None,
                dither: float = 0.0) -> torch.Tensor:
    """Plain PyTorch fbank in f32: (B, N) → (B, max_frames, n_mels);
    `noise` (B, max_frames, frame_length), scaled by `dither`, is added to
    the frames when given."""
    frames = frame_signal(pcm.float(), max_frames, frame_length,
                          frame_shift, snip_edges)
    if noise is not None:
        frames = frames + dither * noise
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


def dither_noise(batch: int, max_frames: int, frame_length: int,
                 generator: torch.Generator,
                 device: torch.device | str) -> torch.Tensor:
    """Standard normal noise for every frame sample, (batch, max_frames,
    frame_length) f32, drawn from `generator` (on `device`)."""
    return torch.randn((batch, max_frames, frame_length),
                       generator=generator, device=device)


def mel_runs(banks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each filter's run of bins from its first to its last non-zero
    weight: runs (n_mels, 3) int32 = first bin, number of bins, offset into
    `weights`, and weights f32, the runs one after another. A filter with
    no non-zero weight gets an empty run."""
    runs = np.zeros((banks.shape[0], 3), np.int32)
    pieces = []
    off = 0
    for m, row in enumerate(banks):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        runs[m] = (lo, hi - lo, off)
        pieces.append(row[lo:hi])
        off += hi - lo
    weights = np.concatenate(pieces).astype(np.float32) if off else \
        np.zeros(1, np.float32)
    return runs, weights


def twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) f32 rows (cos, −sin)(2πk/n_fft), built in float64."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def dft_matrices(frame_length: int, n_fft: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The (frame_length, n_fft//2+1) cos/sin matrices of the n_fft-point
    DFT of a frame zero-padded to n_fft, built in float64, stored as f32."""
    ang = -2.0 * np.pi * np.outer(np.arange(frame_length),
                                  np.arange(n_fft // 2 + 1)) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# id(banks) → (weak reference to banks, versions, operands); an entry goes
# when its banks tensor does
_OPERANDS: Dict[int, tuple] = {}


def fft_size(dft_cos: torch.Tensor) -> int:
    """The FFT size of the (flen, n_fft//2 + 1) DFT matrix; raises unless
    the kernel computes it (a power of two from 128 to 2048)."""
    n_fft = 2 * (dft_cos.shape[1] - 1)
    if n_fft not in FFT_SIZES:
        raise ValueError(f"the fbank kernel computes {FFT_SIZES[0]}- to "
                         f"{FFT_SIZES[-1]}-point DFTs (powers of two); "
                         f"dft_cos has {dft_cos.shape[1]} bins, "
                         f"{n_fft} points")
    return n_fft


def fft_operands(dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                 banks: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(twiddles, runs, weights) on the banks' device for the FFT kernel,
    made once per banks tensor (and again if it, or a DFT matrix, is
    modified). Raises unless dft_cos/dft_sin are the n_fft-point DFT of
    the zero-padded frame, n_fft one of the kernel's sizes."""
    versions = (banks._version, dft_cos.data_ptr(), dft_cos._version,
                dft_sin.data_ptr(), dft_sin._version)
    hit = _OPERANDS.get(id(banks))
    if hit is not None and hit[0]() is banks and hit[1] == versions:
        return hit[2]
    flen = dft_cos.shape[0]
    n_fft = fft_size(dft_cos)
    want = dft_matrices(flen, n_fft) if flen <= n_fft else None
    if want is None or not all(
            np.array_equal(m.detach().cpu().numpy(), w)
            for m, w in zip((dft_cos, dft_sin), want)):
        raise ValueError(f"the fbank kernel computes the {n_fft}-point DFT "
                         f"of a frame of at most {n_fft} samples; "
                         f"dft_cos/dft_sin are another transform")
    runs, weights = mel_runs(banks.detach().cpu().numpy())
    dev = banks.device
    ops = (torch.from_numpy(twiddles(n_fft)).to(dev),
           torch.from_numpy(runs).to(dev), torch.from_numpy(weights).to(dev))
    key = id(banks)
    _OPERANDS[key] = (weakref.ref(banks, lambda _: _OPERANDS.pop(key, None)),
                      versions, ops)
    return ops


def max_frames_of(n_samples: int, frame_length: int, frame_shift: int,
                  snip_edges: bool) -> int:
    """The frames the framing takes from `n_samples` (kaldi's count:
    whole frames with snip_edges, else one per shift, rounded)."""
    if snip_edges:
        return 1 + (n_samples - frame_length) // frame_shift \
            if n_samples >= frame_length else 0
    return (n_samples + frame_shift // 2) // frame_shift


def fbank_cuda(pcm: torch.Tensor, window: torch.Tensor,
               dft_cos: torch.Tensor, dft_sin: torch.Tensor,
               banks: torch.Tensor, max_frames: int, frame_length: int = 400,
               frame_shift: int = 160, preemph: float = 0.97,
               remove_dc: bool = True, snip_edges: bool = True,
               noise: torch.Tensor | None = None,
               dither: float = 0.0) -> torch.Tensor:
    """Launch csrc/fbank.cu on CUDA tensors: either framing, an n_fft-point
    DFT with n_fft in FFT_SIZES and frame_length <= n_fft (`fft_operands`
    checks both), and `noise` (B, max_frames, frame_length) scaled by
    `dither` when given."""
    B, N = pcm.shape
    n_bins = dft_cos.shape[1]
    n_mels = banks.shape[0]
    if max_frames < 1 or max_frames > max_frames_of(
            N, frame_length, frame_shift, snip_edges):
        raise ValueError(f"{max_frames} frames do not fit {N} samples")
    if dft_cos.shape != (frame_length, n_bins) or \
            dft_sin.shape != dft_cos.shape or banks.shape[1] != n_bins \
            or window.shape != (frame_length,):
        raise ValueError("fbank operand shapes disagree")
    dev = pcm.device
    if noise is not None:
        if noise.shape != (B, max_frames, frame_length):
            raise ValueError(f"dither noise {tuple(noise.shape)} is not "
                             f"{(B, max_frames, frame_length)}")
        noise = ready(noise, dev, torch.float32)
    tw, runs, weights = fft_operands(dft_cos, dft_sin, banks)
    if runs.device != dev:
        tw, runs, weights = (t.to(dev) for t in (tw, runs, weights))
    pcm, window = (ready(t, dev, torch.float32) for t in (pcm, window))
    out = torch.empty((B, max_frames, n_mels), dtype=torch.float32,
                      device=dev)
    fn = KERNEL.entry(ENTRY)
    with on_device(dev):
        rc = fn(ptr(pcm), ptr(window), ptr(tw), ptr(runs), ptr(weights),
                ptr(out), ptr(noise), B, N, max_frames, frame_length,
                frame_shift, n_mels, tw.shape[0], int(snip_edges), preemph,
                int(remove_dc), EPSILON, dither, stream_handle(dev))
    KERNEL.check(rc)
    return out


@torch.library.custom_op("speech2text_torch::fbank", mutates_args=())
def fbank_op(pcm: torch.Tensor, window: torch.Tensor, dft_cos: torch.Tensor,
             dft_sin: torch.Tensor, banks: torch.Tensor, max_frames: int,
             frame_length: int, frame_shift: int, preemph: float,
             remove_dc: bool, snip_edges: bool,
             noise: Optional[torch.Tensor] = None,
             dither: float = 0.0) -> torch.Tensor:
    """The features, with `dither * noise` added to the frames when
    `noise` is given: on the CPU by the plain version, on the card by the
    kernel. The two trailing arguments have defaults, so a program
    exported without them calls the op as it did."""
    args = (pcm, window, dft_cos, dft_sin, banks, max_frames, frame_length,
            frame_shift, preemph, remove_dc, snip_edges, noise, dither)
    if not use_kernel(pcm.device):
        return fbank_plain(*args)
    return fbank_cuda(*args)


@fbank_op.register_fake
def _(pcm, window, dft_cos, dft_sin, banks, max_frames, frame_length,
      frame_shift, preemph, remove_dc, snip_edges, noise=None, dither=0.0):
    return pcm.new_empty((pcm.shape[0], max_frames, banks.shape[0]),
                         dtype=torch.float32)


def fbank(pcm: torch.Tensor, window: torch.Tensor, dft_cos: torch.Tensor,
          dft_sin: torch.Tensor, banks: torch.Tensor, max_frames: int,
          frame_length: int = 400, frame_shift: int = 160,
          preemph: float = 0.97, remove_dc: bool = True,
          snip_edges: bool = True, dither: float = 0.0,
          generator: torch.Generator | None = None,
          noise: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) pcm → (B, max_frames, n_mels) f32 log-mel features. Dither
    (dither > 0) applies with `noise` given or drawn here from
    `generator` (training): one draw, the same tensor on either route."""
    if dither > 0.0 and noise is None and generator is not None:
        noise = dither_noise(pcm.shape[0], max_frames, frame_length,
                             generator, pcm.device)
    args = (pcm, window, dft_cos, dft_sin, banks, max_frames, frame_length,
            frame_shift, float(preemph), bool(remove_dc), bool(snip_edges))
    if dither > 0.0 and noise is not None:
        return fbank_op(*args, noise, float(dither))
    return fbank_op(*args)
