"""Transducer joiner (port of speech2text_tpu/models/joiner.py), serving
half: `_join` and `streaming_step`. The pruned-RNN-T training branch
(prune ranges and the pruned joint) comes with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .layers import Dense, dtype_of


@dataclasses.dataclass
class JoinerConfig:
    input_dim: int              # encoder/predictor output dim
    output_dim: int             # vocab size
    inner_dim: int = 256
    activation: str = "relu"    # "relu" | "tanh"
    prune_range: int = 5        # used by training only
    lm_scale: float = 0.0
    am_scale: float = 0.0
    use_out_project: bool = True
    dtype: str = "float32"


class Joiner(nn.Module):
    def __init__(self, config: JoinerConfig):
        super().__init__()
        cfg = self.config = config
        dt = dtype_of(cfg.dtype)
        self.enc_proj = Dense(cfg.input_dim, cfg.output_dim, dtype=dt)
        self.pre_proj = Dense(cfg.input_dim, cfg.output_dim, dtype=dt)
        if cfg.activation not in ("relu", "tanh"):
            raise ValueError(f"unsupported activation {cfg.activation}")
        if cfg.use_out_project:
            self.out_proj_a = Dense(cfg.output_dim, cfg.inner_dim, dtype=dt)
            self.out_proj_b = Dense(cfg.inner_dim, cfg.output_dim, dtype=dt)

    @property
    def blank_token(self) -> int:
        return 0

    def _join(self, am: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
        h = am + lm
        h = torch.relu(h) if self.config.activation == "relu" \
            else torch.tanh(h)
        if self.config.use_out_project:
            h = self.out_proj_b(self.out_proj_a(h))
        return h.float()

    def streaming_step(self, encoder_frame: torch.Tensor,
                       predictor_out: torch.Tensor) -> torch.Tensor:
        """encoder_frame (B, D) × predictor_out (B, D) → log-probs (B, V)."""
        logits = self._join(self.enc_proj(encoder_frame),
                            self.pre_proj(predictor_out))
        return torch.log_softmax(logits, dim=-1)
