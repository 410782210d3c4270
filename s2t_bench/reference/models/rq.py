"""BEST-RQ's targets in plain PyTorch (Chiu et al. 2022, arXiv:2202.01855;
the port's speech2text_torch/models/best_rq.py): a frozen random
projection of 4 stacked frames and frozen codebooks give each label
frame one label per codebook, and static spans of the augmented
features are replaced by noise.

- the projector (xavier-uniform, (stack · feature_dim, codebook_dim))
  and the codebooks (standard normal, (num_codebooks, codebook_size,
  codebook_dim)) come from `np.random.default_rng(seed)` in that order;
- a label is the codebook entry nearest the projected stacked raw
  features: the largest product of the two l2-normalised vectors
  (cosine), or the least ‖c‖² − 2 p·c (euclidean); equal values take
  the lower index;
- a label frame starts a span with probability mask_proportion /
  mean_span_length, drawn as torch.rand((B, T2)) < that; the span covers
  mean_span_length label frames (static), cut at each utterance's valid
  frames; the masked frames of the augmented features (each label frame
  is `stack` feature frames) become noise_std · N(0, 1), drawn as one
  torch.randn of the features' shape after the starts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Quantizer:

    def __init__(self, cfg: Dict, feature_dim: int, device: torch.device):
        self.stack = int(cfg.get("stack_size", 4))
        self.distance = cfg.get("distance", "euclidean")
        n = int(cfg.get("num_codebooks", 16))
        size = int(cfg.get("codebook_size", 8192))
        dim = int(cfg.get("codebook_dim", 16))
        rng = np.random.default_rng(int(cfg.get("seed", 1234)))
        d_in = feature_dim * self.stack
        limit = np.sqrt(6.0 / (d_in + dim))
        projector = rng.uniform(-limit, limit, (d_in, dim))
        books = rng.standard_normal((n, size, dim)).astype(np.float32)
        self.projector = torch.from_numpy(
            projector.astype(np.float32)).to(device)
        self.books = torch.from_numpy(books).to(device)

    @torch.no_grad()
    def labels(self, raw: torch.Tensor, lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels (n, B, T2) int64, label-frame lengths (B,))."""
        B, T, D = raw.shape
        T2 = T // self.stack
        stacked = raw.float()[:, :T2 * self.stack].reshape(
            B, T2, self.stack * D)
        proj = stacked @ self.projector
        out = []
        for book in self.books:
            if self.distance == "cosine":
                p = proj / (proj.norm(dim=-1, keepdim=True) + 1e-8)
                c = book / (book.norm(dim=-1, keepdim=True) + 1e-8)
                out.append((p @ c.T).argmax(dim=-1))
            else:
                out.append((book.square().sum(dim=-1)
                            - 2.0 * (proj @ book.T)).argmin(dim=-1))
        return torch.stack(out), torch.div(lens, self.stack,
                                           rounding_mode="floor")


def mask_and_noise(masking: Dict, stack: int, feats: torch.Tensor,
                   lens2: torch.Tensor, T2: int,
                   generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the masked features, the label-frame mask (B, T2) bool)."""
    B, T, _ = feats.shape
    span = max(int(masking.get("mean_span_length", 2)), 1)
    p = float(masking.get("mask_proportion", 0.5)) / span
    starts = torch.rand((B, T2), generator=generator,
                        device=feats.device) < p
    noise = torch.randn(feats.shape, generator=generator,
                        device=feats.device)
    # frame t is masked when a span starts in t − span + 1 .. t
    padded = F.pad(starts.float()[:, None, :], (span - 1, 0))
    covered = F.max_pool1d(padded, span, stride=1)[:, 0] > 0
    valid = torch.arange(T2, device=feats.device)[None, :] < lens2[:, None]
    mask2 = covered & valid
    frames = torch.zeros((B, T), dtype=torch.bool, device=feats.device)
    frames[:, :T2 * stack] = mask2.repeat_interleave(stack, dim=1)
    std = float(masking.get("noise_std", 0.1))
    return torch.where(frames[..., None], noise * std, feats), mask2
