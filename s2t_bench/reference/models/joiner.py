"""Transducer joiner (port of speech2text_tpu/models/joiner.py).

`forward` is the training joint: with `prune_range > 0` it takes the
smoothed simple loss on the projected am/lm, the prune ranges from its
occupancies, and joins the pruned (B, T, prune_range, V) pairs
(ops/pruned_rnnt.py); otherwise it joins the full (B, T, U+1, V) lattice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.pruned_rnnt import (do_rnnt_pruning, get_rnnt_prune_ranges,
                               rnnt_loss_smoothed)
from .layers import Dense, dtype_of


@dataclasses.dataclass
class JoinerConfig:
    input_dim: int              # encoder/predictor output dim
    output_dim: int             # vocab size
    inner_dim: int = 256
    activation: str = "relu"    # "relu" | "tanh"
    prune_range: int = 5        # -1 → full (unpruned) joint
    lm_scale: float = 0.0       # simple-loss smoothing scales
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

    def forward(self, encoder_out: torch.Tensor,
                encoder_out_lengths: torch.Tensor,
                predict_out: torch.Tensor, target_lengths: torch.Tensor,
                target: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        """encoder_out (B, T, D), predict_out (B, U+1, D) →
        (logits, ranges, simple_loss).

        pruned:   logits (B, T, prune_range, V), ranges (B, T) int32, the
                  mean simple loss;
        unpruned: logits (B, T, U+1, V), None, None."""
        am = self.enc_proj(encoder_out)
        lm = self.pre_proj(predict_out)
        r = self.config.prune_range
        if r <= 0:
            logits = self._join(am[:, :, None, :], lm[:, None, :, :])
            return logits, None, None
        if target is None:
            raise ValueError("the pruned joiner needs the targets")
        simple_loss, (px_g, py_g) = rnnt_loss_smoothed(
            lm, am, target, encoder_out_lengths, target_lengths,
            termination_symbol=self.blank_token,
            lm_only_scale=self.config.lm_scale,
            am_only_scale=self.config.am_scale, reduction="mean")
        ranges = get_rnnt_prune_ranges(px_g, py_g, encoder_out_lengths,
                                       target_lengths, s_range=r)
        am_p, lm_p = do_rnnt_pruning(am, lm, ranges, s_range=r)
        return self._join(am_p, lm_p), ranges, simple_loss
