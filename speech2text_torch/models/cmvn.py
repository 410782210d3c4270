"""Global CMVN (port of speech2text_tpu/models/cmvn.py):
(x − mean) · istd with precomputed statistics, identity when none, and
`compute_cmvn_stats`, the statistics over featurized batches in f64 on
the host. The JSON file ({"mean": [...], "istd": [...]}) is the JAX
package's format: a file written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Iterable, Tuple

import numpy as np
import torch
from torch import nn


class GlobalCmvn(nn.Module):

    def __init__(self, mean: np.ndarray | None = None,
                 istd: np.ndarray | None = None):
        super().__init__()
        self.register_buffer(
            "mean", None if mean is None
            else torch.as_tensor(np.asarray(mean, np.float32)))
        self.register_buffer(
            "istd", None if istd is None
            else torch.as_tensor(np.asarray(istd, np.float32)))

    @classmethod
    def from_file(cls, path: str) -> "GlobalCmvn":
        with open(path) as f:
            obj = json.load(f)
        return cls(np.asarray(obj["mean"], np.float32),
                   np.asarray(obj["istd"], np.float32))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"mean": self.mean.cpu().numpy().tolist(),
                       "istd": self.istd.cpu().numpy().tolist()}, f)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        if self.mean is None:
            return feats
        return (feats - self.mean) * self.istd


def compute_cmvn_stats(
    feat_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
) -> GlobalCmvn:
    """mean and istd over the valid frames of (feats (B, T, D), lengths
    (B,)) batches, accumulated in f64 (variance floored at 1e-8)."""
    total = None
    total_sq = None
    count = 0
    for feats, lens in feat_batches:
        feats = np.asarray(feats, np.float64)
        mask = (np.arange(feats.shape[1])[None, :]
                < np.asarray(lens)[:, None]).astype(np.float64)
        s = (feats * mask[..., None]).sum(axis=(0, 1))
        sq = (feats ** 2 * mask[..., None]).sum(axis=(0, 1))
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += mask.sum()
    mean = total / count
    var = np.maximum(total_sq / count - mean ** 2, 1e-8)
    return GlobalCmvn(mean.astype(np.float32),
                      (1.0 / np.sqrt(var)).astype(np.float32))
