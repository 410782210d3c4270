"""Decoder heads (port of speech2text_tpu/models/decoder.py): `Identity`
passes the encoder output and lengths on; `Projector` is dropout → Dense
→ f32 logits over the vocabulary (the CTC head of a CTC task, the CTC
branch of a pruned RNN-T task)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Dense, dropout, dtype_of


@dataclasses.dataclass
class IdentityDecoderConfig:
    dummy: int = -1


class IdentityDecoder(nn.Module):
    def __init__(self, config: IdentityDecoderConfig):
        super().__init__()
        self.config = config

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return x, lengths


@dataclasses.dataclass
class ProjectorDecoderConfig:
    input_dim: int = 256
    num_classes: int = 128
    dropout_p: float = 0.1
    dtype: str = "float32"


class ProjectorDecoder(nn.Module):
    def __init__(self, config: ProjectorDecoderConfig):
        super().__init__()
        self.config = config
        self.dtype = dtype_of(config.dtype)
        self.Dense_0 = Dense(config.input_dim, config.num_classes,
                             dtype=self.dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`training` turns on the input dropout, drawn from
        `generator`."""
        h = dropout(x.to(self.dtype), self.config.dropout_p, training,
                    generator)
        return self.Dense_0(h).float(), lengths
