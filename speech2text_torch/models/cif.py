"""Continuous integrate-and-fire (port of speech2text_tpu/models/cif.py).

`integrate_and_fire` walks the encoder frames in order, as JAX's
`lax.scan` does, with the same f32 arithmetic: add the frame's weight α
to the accumulator; when it reaches `threshold`, emit the running
embedding plus the left part of the frame (α less what overflows the
threshold) into the next slot, never at or past `u_cap`, and restart
from the right part. The loop collects each frame's candidate emission
and writes the (B, u_cap, D) buffer once at the end by a scatter, so
autograd differentiates through every emission.

`CifLayer` predicts the weights: a causal depthwise conv (k − 1 frames
of left padding, then VALID) → ReLU → a Dense to one value → sigmoid,
zero past each length; their sum is the predicted token count. In
training the weights are rescaled so that they sum to the target length
U; at inference a residual of at least `tail_threshold` fires one more
token. With Σα = U the U-th fire depends on the rounding of the sum, so
it may or may not happen (ROADMAP §C, reference caveat 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Dense


@dataclasses.dataclass
class CifConfig:
    input_dim: int = 256
    conv_kernel: int = 3
    threshold: float = 1.0
    tail_threshold: float = 0.5
    max_tokens: int = 128   # u_cap, the emission buffer's slots
    dtype: str = "float32"


def integrate_and_fire(hidden: torch.Tensor, alphas: torch.Tensor,
                       u_cap: int, threshold: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """hidden (B, T, D), alphas (B, T) ≥ 0 → (embeds (B, u_cap, D), the
    fires written (B,) int32, the final accumulator (B,), the running
    embedding after the last frame (B, D)). One fire per frame at most,
    as in the reference (α ≤ 1)."""
    B, T, D = hidden.shape
    hidden = hidden.float()
    alphas = alphas.float()
    accum = hidden.new_zeros(B)
    embed = hidden.new_zeros(B, D)
    count = torch.zeros(B, dtype=torch.int32, device=hidden.device)
    emits, slots = [], []
    for t in range(T):
        h_t, a_t = hidden[:, t], alphas[:, t]
        new_accum = accum + a_t
        fired = new_accum >= threshold
        right = torch.where(fired, new_accum - threshold, 0.0)
        left = a_t - right
        emits.append(embed + left[:, None] * h_t)
        write = fired & (count < u_cap)
        slots.append(torch.where(write, count, u_cap))
        count = count + write.to(torch.int32)
        accum = torch.where(fired, right, new_accum)
        embed = torch.where(fired[:, None], right[:, None] * h_t,
                            embed + a_t[:, None] * h_t)
    # frames that wrote nothing go to a spare slot u_cap, cut off here
    index = torch.stack(slots, dim=1).long()[..., None].expand(B, T, D)
    embeds = hidden.new_zeros(B, u_cap + 1, D).scatter(
        1, index, torch.stack(emits, dim=1))[:, :u_cap]
    return embeds, count, accum, embed


class CifLayer(nn.Module):
    """The weight predictor and integrate-and-fire; submodules keep the
    flax names (`alpha_conv`, `alpha_proj`)."""

    def __init__(self, config: CifConfig):
        super().__init__()
        self.config = config
        D, k = config.input_dim, config.conv_kernel
        self.alpha_conv = Conv(D, D, (k,), groups=D)
        self.alpha_proj = Dense(D, 1)

    def alphas(self, hidden: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        """The firing weights (B, T), zero at and past each length."""
        k = self.config.conv_kernel
        h = self.alpha_conv(F.pad(hidden.float(), (0, 0, k - 1, 0)))
        a = torch.sigmoid(self.alpha_proj(F.relu(h))[..., 0])
        T = hidden.shape[1]
        valid = torch.arange(T, device=a.device)[None, :] < lengths[:, None]
        return torch.where(valid, a, 0.0)

    def forward(self, hidden: torch.Tensor, lengths: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(acoustic embeddings (B, u_cap, D), the predicted counts Σα
        (B,), the tokens emitted (B,) int32). With `target_lengths` (U,
        training) the weights are rescaled to sum to U; without, the
        residual fires a last token when it reaches `tail_threshold`."""
        cfg = self.config
        alphas = self.alphas(hidden, lengths)
        pred_counts = alphas.sum(dim=1)
        if target_lengths is not None:
            scale = target_lengths.float() / pred_counts.clamp(min=1e-6)
            embeds, count, _, _ = integrate_and_fire(
                hidden, alphas * scale[:, None], cfg.max_tokens,
                cfg.threshold)
            return embeds, pred_counts, count
        embeds, count, accum, embed = integrate_and_fire(
            hidden, alphas, cfg.max_tokens, cfg.threshold)
        tail = (accum >= cfg.tail_threshold) & (count < cfg.max_tokens)
        slots = torch.arange(cfg.max_tokens, device=hidden.device)
        write = tail[:, None] & (slots[None, :] == count[:, None])
        embeds = torch.where(write[..., None], embed[:, None, :], embeds)
        return embeds, pred_counts, count + tail.to(torch.int32)
