"""The stateless transducer predictor (port of
speech2text_tpu/models/predictor.py): embedding → bias-free depthwise
Conv1d over the last `context_size` tokens → output Dense, with no
activation in between, as in the JAX package. Training only: the
decoding state and step are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .layers import Conv, Dense, Embed, dtype_of


@dataclasses.dataclass
class StatelessPredictorConfig:
    num_symbols: int = 128
    output_dim: int = 256
    symbol_embedding_dim: int = 512
    context_size: int = 5
    dtype: str = "float32"


class StatelessPredictor(nn.Module):
    def __init__(self, config: StatelessPredictorConfig):
        super().__init__()
        cfg = self.config = config
        dt = dtype_of(cfg.dtype)
        E = cfg.symbol_embedding_dim
        self.embed = Embed(cfg.num_symbols, E, dtype=dt)
        if cfg.context_size > 1:
            self.conv = Conv(E, E, (cfg.context_size,), groups=E, bias=False,
                             dtype=dt)
        self.out = Dense(E, cfg.output_dim, dtype=dt)

    def _net(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) left-padded with context → (B, L−context+1, D)."""
        h = self.embed(tokens)
        if self.config.context_size > 1:
            h = self.conv(h)
        return self.out(h).float()

    def forward(self, targets: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None):
        """targets (B, U) → (B, U+1, output_dim); row u conditions on
        y_1..y_u (row 0 on blank context only)."""
        B, U = targets.shape
        ctx = targets.new_zeros((B, self.config.context_size))
        out = self._net(torch.cat([ctx, targets], dim=1))[:, -(U + 1):]
        if target_lengths is None:
            return out
        return out, target_lengths.to(torch.int32) + 1
