"""Global CMVN (port of speech2text_tpu/models/cmvn.py):
(x − mean) · istd with precomputed statistics, identity when none."""

from __future__ import annotations

import json

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

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        if self.mean is None:
            return feats
        return (feats - self.mean) * self.istd
