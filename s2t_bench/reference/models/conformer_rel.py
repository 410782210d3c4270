"""The Conformer encoder with Transformer-XL relative-position attention,
in plain PyTorch (Gulati et al. 2020, arXiv:2005.08100; the port's
speech2text_torch/models/conformer.py with `pos_enc: rel`).

Conv subsampling by 4 (two strided 3×3 Conv2d + ReLU over (time,
feature), a Dense of the flattened axes) → blocks (½·FFN, MHSA, conv
module, ½·FFN, each pre-normed and residual, then a LayerNorm) → a
Dense, zeroed at padded frames, in f32. Parameters are f32; each Dense
and Conv computes in the config's dtype (models/layers.py), norms,
scores and softmax in f32. LayerNorm (ε = 1e-6) stands in for the
conv module's batch norm; dropout falls after the FFN's swish and on the
attention weights. Submodules carry the port's names, so one
state_dict fits both.

Attention: score(i, j) = [(q_i + u)·k_j + (q_i + v)·P_{i−j}] / √d_k,
P = R·W_pos with R the (2T − 1, D) sinusoidal table of offsets T − 1
down to −(T − 1) (sin at even features, cos at odd). The positional
term is read from (q + v)·Pᵀ over every offset by a gather of column
T − 1 − i + j. The dropout mask is drawn before the scores, and the
scores, softmax and weighted sum are recomputed in the backward
(torch.utils.checkpoint), so a layer keeps its inputs and the mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import Conv, Dense, dropout, dtype_of


@dataclasses.dataclass
class ConformerRelConfig:
    feats_dim: int = 80
    subsampling_rate: int = 4
    input_dim: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    num_layers: int = 12
    depthwise_conv_kernel_size: int = 31
    output_dim: int = 256
    dropout: float = 0.1
    dtype: str = "float32"
    pos_enc: str = "rel"

    def __post_init__(self):
        if self.pos_enc != "rel":
            raise ValueError(f"the reference has relative attention only, "
                             f"not pos_enc {self.pos_enc!r}")
        if self.subsampling_rate != 4:
            raise ValueError(f"the reference subsamples by 4, not "
                             f"{self.subsampling_rate}")


class LayerNorm(nn.Module):
    """Over the last axis, statistics in f32, ε = 1e-6; the result in
    `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-6).to(self.dtype)


class ConvSubsampling(nn.Module):

    def __init__(self, feats_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(1, out_dim, (3, 3), (2, 2), dtype=dtype)
        self.Conv_1 = Conv(out_dim, out_dim, (3, 3), (2, 2), dtype=dtype)
        d = ((feats_dim - 3) // 2 + 1 - 3) // 2 + 1
        self.Dense_0 = Dense(d * out_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.Conv_1(F.relu(self.Conv_0(x[..., None]))))
        B, T, D, C = h.shape
        lens = lengths.to(torch.int32)
        for _ in range(2):
            lens = torch.div(lens - 3, 2, rounding_mode="floor") + 1
        return self.Dense_0(h.reshape(B, T, D * C)), lens.clamp(min=0)


def position_table(T: int, dim: int, device: torch.device) -> torch.Tensor:
    """(2T − 1, dim) f32 from float64: row r is the offset T − 1 − r."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float64)[:, None]
    m = torch.arange(dim // 2, dtype=torch.float64)[None, :]
    angle = pos * 10000.0 ** (-2.0 * m / dim)
    table = torch.empty(2 * T - 1, dim, dtype=torch.float64)
    table[:, 0::2] = torch.sin(angle)
    table[:, 1::2] = torch.cos(angle)
    return table.float().to(device)


def attention_core(q, k, v, u, vb, p, key_mask, keep, rate, dtype):
    """The heads' outputs (B, H, T, d) f32 of q, k, v (B, H, T, d), u, vb
    (H, d), P (H, 2T − 1, d), the key mask (B, T) and the dropout mask
    `keep` (B, H, T, T) or None."""
    B, H, T, d = q.shape
    q = q.float()
    ac = torch.matmul(q + u[:, None, :], k.float().transpose(-1, -2))
    every = torch.matmul(q + vb[:, None, :], p.transpose(-1, -2))
    i = torch.arange(T, device=q.device)
    column = (T - 1 - i[:, None] + i[None, :]).expand(B, H, T, T)
    bd = torch.gather(every, -1, column)
    scores = (ac + bd) / math.sqrt(d)
    scores = scores.masked_fill(~key_mask[:, None, None, :], -1e30)
    attn = torch.softmax(scores, dim=-1).to(dtype)
    if keep is not None:
        attn = torch.where(keep, attn / (1.0 - rate), 0.0)
    return torch.matmul(attn.float(), v.float())


class MaskedMHSA(nn.Module):

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        hd = dim // num_heads
        self.Dense_0 = Dense(dim, 3 * dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)
        self.Dense_2 = Dense(dim, dim, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, hd))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, hd))

    def forward(self, x, pad_mask, rate, training, generator):
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
                   for t in self.Dense_0(x).chunk(3, dim=-1))
        p = self.Dense_2(position_table(T, D, x.device)).float()
        p = p.reshape(2 * T - 1, H, hd).transpose(0, 1)
        keep = None
        if training and rate > 0.0:
            keep = torch.rand((B, H, T, T), generator=generator,
                              device=x.device) < 1.0 - rate
        args = (q, k, v, self.pos_bias_u, self.pos_bias_v, p, pad_mask,
                keep, rate, self.dtype)
        if torch.is_grad_enabled():
            out = checkpoint(attention_core, *args, use_reentrant=False)
        else:
            out = attention_core(*args)
        out = out.transpose(1, 2).reshape(B, T, D).to(self.dtype)
        return self.Dense_1(out)


class ConvModule(nn.Module):

    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2,
                    kernel_size - 1 - (kernel_size - 1) // 2)
        self.Dense_0 = Dense(dim, 2 * dim, dtype=dtype)
        self.Conv_0 = Conv(dim, dim, (kernel_size,), groups=dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)

    def forward(self, x, pad_mask):
        h = F.glu(self.Dense_0(x), dim=-1)
        h = h * pad_mask[..., None].to(h.dtype)
        h = self.Conv_0(F.pad(h, (0, 0) + self.pad))
        return self.Dense_1(F.silu(self.LayerNorm_0(h)))


class FeedForward(nn.Module):

    def __init__(self, dim: int, ffn_dim: int, dtype: torch.dtype):
        super().__init__()
        self.Dense_0 = Dense(dim, ffn_dim, dtype=dtype)
        self.Dense_1 = Dense(ffn_dim, dim, dtype=dtype)

    def forward(self, x, rate, training, generator):
        return self.Dense_1(dropout(F.silu(self.Dense_0(x)), rate, training,
                                    generator))


class ConformerBlock(nn.Module):

    def __init__(self, cfg: ConformerRelConfig, dtype: torch.dtype):
        super().__init__()
        D = cfg.input_dim
        self.rate = cfg.dropout
        self.FeedForward_0 = FeedForward(D, cfg.ffn_dim, dtype)
        self.MaskedMHSA_0 = MaskedMHSA(D, cfg.num_heads, dtype)
        self.ConvModule_0 = ConvModule(D, cfg.depthwise_conv_kernel_size,
                                       dtype)
        self.FeedForward_1 = FeedForward(D, cfg.ffn_dim, dtype)
        for i in range(5):
            self.add_module(f"LayerNorm_{i}", LayerNorm(D, dtype))

    def forward(self, x, pad_mask, training, generator):
        r = self.rate
        x = x + 0.5 * self.FeedForward_0(self.LayerNorm_0(x), r, training,
                                         generator)
        x = x + self.MaskedMHSA_0(self.LayerNorm_1(x), pad_mask, r, training,
                                  generator)
        x = x + self.ConvModule_0(self.LayerNorm_2(x), pad_mask)
        x = x + 0.5 * self.FeedForward_1(self.LayerNorm_3(x), r, training,
                                         generator)
        return self.LayerNorm_4(x)


class ConformerRel(nn.Module):

    def __init__(self, cfg: ConformerRelConfig):
        super().__init__()
        self.config = cfg
        dt = dtype_of(cfg.dtype)
        self.ConvSubsampling_0 = ConvSubsampling(cfg.feats_dim,
                                                 cfg.input_dim, dt)
        for i in range(cfg.num_layers):
            self.add_module(f"ConformerBlock_{i}", ConformerBlock(cfg, dt))
        self.Dense_0 = Dense(cfg.input_dim, cfg.output_dim, dtype=dt)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, feats_dim) → ((B, T', output_dim) f32, zero past each
        output length; the output lengths)."""
        h, lens = self.ConvSubsampling_0(feats, lengths)
        pad_mask = torch.arange(h.shape[1], device=h.device)[None, :] \
            < lens[:, None]
        for i in range(self.config.num_layers):
            h = getattr(self, f"ConformerBlock_{i}")(h, pad_mask, training,
                                                     generator)
        out = self.Dense_0(h) * pad_mask[..., None].to(h.dtype)
        return out.float(), lens
