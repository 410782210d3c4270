"""Frame counts of the fbank frontend (kaldi's snip_edges framing)."""


def fbank_frames(n_samples: int, frame_length: int = 400,
                 frame_shift: int = 160) -> int:
    if n_samples < frame_length:
        return 0
    return 1 + (n_samples - frame_length) // frame_shift
