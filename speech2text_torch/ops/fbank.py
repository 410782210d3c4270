"""Kaldi log-mel fbank: kernel B2's wrapper and its plain version.

`fbank` dispatches on the PCM's device: a CPU tensor takes `fbank_plain`,
a CUDA tensor launches csrc/fbank.cu (snip_edges framing only) or
raises. `fbank_plain` mirrors speech2text_tpu/data/frontend.py:_fbank_impl
(without dither: the port serves, it does not train), including both
framings of `frame_signal`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, ptr, stream_handle, use_kernel

EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's log floor
KERNEL = CudaKernel("fbank", "fbank.cu")


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


def fbank_cuda(pcm: torch.Tensor, window: torch.Tensor,
               dft_cos: torch.Tensor, dft_sin: torch.Tensor,
               banks: torch.Tensor, max_frames: int, frame_length: int = 400,
               frame_shift: int = 160, preemph: float = 0.97,
               remove_dc: bool = True) -> torch.Tensor:
    """Launch csrc/fbank.cu on CUDA tensors (snip_edges framing)."""
    B, N = pcm.shape
    n_bins = dft_cos.shape[1]
    n_mels = banks.shape[0]
    if max_frames < 1 or (max_frames - 1) * frame_shift + frame_length > N:
        raise ValueError(f"{max_frames} frames do not fit {N} samples")
    if frame_length > 512 or n_bins > 288:
        raise ValueError(f"fbank kernel takes frame_length <= 512 and "
                         f"<= 288 bins, got {frame_length}, {n_bins}")
    if dft_cos.shape != (frame_length, n_bins) or \
            dft_sin.shape != dft_cos.shape or banks.shape[1] != n_bins \
            or window.shape != (frame_length,):
        raise ValueError("fbank operand shapes disagree")
    dev = pcm.device
    args = [a.to(device=dev, dtype=torch.float32).contiguous()
            for a in (pcm, window, dft_cos, dft_sin, banks)]
    out = torch.empty((B, max_frames, n_mels), dtype=torch.float32,
                      device=dev)
    fn = KERNEL.lib().fbank_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*[ptr(a) for a in args], ptr(out), B, N, max_frames,
                frame_length, frame_shift, n_bins, n_mels, preemph,
                int(remove_dc), EPSILON, stream_handle(dev))
    KERNEL.check(rc)
    return out


def fbank(pcm: torch.Tensor, window: torch.Tensor, dft_cos: torch.Tensor,
          dft_sin: torch.Tensor, banks: torch.Tensor, max_frames: int,
          frame_length: int = 400, frame_shift: int = 160,
          preemph: float = 0.97, remove_dc: bool = True,
          snip_edges: bool = True) -> torch.Tensor:
    """(B, N) pcm → (B, max_frames, n_mels) f32 log-mel features."""
    if not use_kernel(pcm.device):
        return fbank_plain(pcm, window, dft_cos, dft_sin, banks, max_frames,
                           frame_length, frame_shift, preemph, remove_dc,
                           snip_edges)
    if not snip_edges:
        raise NotImplementedError(
            "the fbank kernel frames with snip_edges=True only")
    return fbank_cuda(pcm, window, dft_cos, dft_sin, banks, max_frames,
                      frame_length, frame_shift, preemph, remove_dc)
