"""Conformer encoder (port of speech2text_tpu/models/conformer.py).

Conv subsampling at rates 4, 6 or 8 → `num_layers` Conformer blocks
(½·FFN, masked MHSA, conv module, ½·FFN, each pre-normed and residual,
then a final LayerNorm) → an output Dense, zeroed at padded frames and
returned in f32 with the output lengths.

Submodules keep flax's auto-generated names (`ConvSubsampling_0`,
`ConformerBlock_{i}`, `Dense_0`, `LayerNorm_{i}`, ...), so the state_dict
follows the flax tree name for name (speech2text_torch/convert.py).
Parameters are f32; each layer computes in the config's dtype.

As in the JAX package: attention scores and softmax in f32 with padded
keys at −1e30 (a fully padded row comes out uniform), padded frames
zeroed before the depthwise conv so their values never reach valid
frames, LayerNorm (ε = 1e-6) in place of batch norm. Dropout, in
training only, falls after the FFN's swish, on the attention weights,
and is drawn from an explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masking import make_non_pad_mask
from .layers import Conv, Dense, LayerNorm, dropout, dtype_of


@dataclasses.dataclass
class ConformerConfig:
    feats_dim: int = 80
    subsampling_rate: int = 4
    input_dim: int = 256          # the blocks' model width
    num_heads: int = 4
    ffn_dim: int = 1024
    num_layers: int = 12
    depthwise_conv_kernel_size: int = 31
    output_dim: int = 256
    dropout: float = 0.1
    dtype: str = "float32"


class ConvSubsampling(nn.Module):
    """Stacked strided 3×3 Conv2d + ReLU over (time, feature), then a
    Dense of the flattened (feature, channel) axes."""

    STRIDES = {4: (2, 2), 6: (2, 3), 8: (2, 2, 2)}

    def __init__(self, rate: int, feats_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if rate not in self.STRIDES:
            raise ValueError(f"subsampling_rate {rate} (4, 6 or 8)")
        self.strides = self.STRIDES[rate]
        d, c_in = feats_dim, 1
        for i, s in enumerate(self.strides):
            self.add_module(f"Conv_{i}", Conv(c_in, out_dim, (3, 3), (s, s),
                                              dtype=dtype))
            d, c_in = (d - 3) // s + 1, out_dim
        self.Dense_0 = Dense(d * out_dim, out_dim, dtype=dtype)

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        out = lengths.to(torch.int32)
        for s in self.strides:
            out = torch.div(out - 3, s, rounding_mode="floor") + 1
        return out.clamp(min=0)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x[..., None]                          # (B, T, D, 1), NHWC
        for i in range(len(self.strides)):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
        B, T2, D2, C = h.shape                    # channels last, as flax
        return self.Dense_0(h.reshape(B, T2, D2 * C)), \
            self.output_lengths(lengths)


class MaskedMHSA(nn.Module):
    """Multi-head self-attention without positional terms, padded keys
    masked."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.Dense_0 = Dense(dim, 3 * dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                rate: float = 0.0, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
                   for t in self.Dense_0(x).chunk(3, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        scores = torch.where(pad_mask[:, None, None, :], scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        attn = dropout(attn, rate, training, generator)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(B, T, D).to(self.dtype)
        return self.Dense_1(out)


class ConvModule(nn.Module):
    """Pointwise Dense → GLU → padded frames zeroed → depthwise conv
    (SAME) → LayerNorm → swish → pointwise Dense."""

    def __init__(self, dim: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1
                    - (kernel_size - 1) // 2)
        self.Dense_0 = Dense(dim, 2 * dim, dtype=dtype)
        self.Conv_0 = Conv(dim, dim, (kernel_size,), groups=dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        h = F.glu(self.Dense_0(x), dim=-1)
        h = torch.where(pad_mask[..., None], h, 0.0)
        h = self.Conv_0(F.pad(h, (0, 0) + self.pad))
        return self.Dense_1(F.silu(self.LayerNorm_0(h)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, rate: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = rate
        self.Dense_0 = Dense(dim, ffn_dim, dtype=dtype)
        self.Dense_1 = Dense(ffn_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = dropout(F.silu(self.Dense_0(x)), self.rate, training, generator)
        return self.Dense_1(h)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 kernel_size: int, rate: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = rate
        self.FeedForward_0 = FeedForward(dim, ffn_dim, rate, dtype)
        self.MaskedMHSA_0 = MaskedMHSA(dim, num_heads, dtype)
        self.ConvModule_0 = ConvModule(dim, kernel_size, dtype)
        self.FeedForward_1 = FeedForward(dim, ffn_dim, rate, dtype)
        for i in range(5):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim, dtype=dtype))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + 0.5 * self.FeedForward_0(self.LayerNorm_0(x), training,
                                         generator)
        x = x + self.MaskedMHSA_0(self.LayerNorm_1(x), pad_mask, self.rate,
                                  training, generator)
        x = x + self.ConvModule_0(self.LayerNorm_2(x), pad_mask)
        x = x + 0.5 * self.FeedForward_1(self.LayerNorm_3(x), training,
                                         generator)
        return self.LayerNorm_4(x)


class Conformer(nn.Module):
    def __init__(self, config: ConformerConfig):
        super().__init__()
        cfg = self.config = config
        dt = dtype_of(cfg.dtype)
        self.ConvSubsampling_0 = ConvSubsampling(
            cfg.subsampling_rate, cfg.feats_dim, cfg.input_dim, dt)
        for i in range(cfg.num_layers):
            self.add_module(f"ConformerBlock_{i}", ConformerBlock(
                cfg.input_dim, cfg.num_heads, cfg.ffn_dim,
                cfg.depthwise_conv_kernel_size, cfg.dropout, dt))
        self.Dense_0 = Dense(cfg.input_dim, cfg.output_dim, dtype=dt)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                chunk_size: int = -1, left_context_chunks: int = -1,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (B, T, feats_dim), lengths (B,) → (out (B, T', output_dim)
        f32, zero past each length; out_lens (B,) int32). The Conformer
        attends over the whole utterance: like the JAX package's, it
        takes no chunk, and `chunk_size`/`left_context_chunks` (the
        Zipformer2's streaming arguments) are not used. `training` turns
        on dropout, drawn from `generator`."""
        h, out_lens = self.ConvSubsampling_0(feats, lengths)
        pad_mask = make_non_pad_mask(out_lens, h.shape[1])
        for i in range(self.config.num_layers):
            h = getattr(self, f"ConformerBlock_{i}")(h, pad_mask, training,
                                                     generator)
        out = torch.where(pad_mask[..., None], self.Dense_0(h), 0.0)
        return out.float(), out_lens
