"""Mask construction (port of speech2text_tpu/ops/masking.py).

Convention: True = valid position (non-pad) / may attend.
"""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, max_len) bool, True where t < length."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int64)[:, None]


def chunk_causal_mask(size: int, chunk_size: int,
                      left_context_chunks: int = -1,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(size, size) chunk-causal mask: query i attends to its own chunk and
    up to `left_context_chunks` chunks to its left (-1 = unlimited).
    chunk_size <= 0 means full attention."""
    if chunk_size <= 0:
        return torch.ones((size, size), dtype=torch.bool, device=device)
    idx = torch.arange(size, device=device) // chunk_size
    chunk_i, chunk_j = idx[:, None], idx[None, :]
    ok = chunk_j <= chunk_i
    if left_context_chunks >= 0:
        ok = ok & (chunk_j >= chunk_i - left_context_chunks)
    return ok
