"""Wav2Vec2 raw-waveform encoder (port of speech2text_tpu/models/wav2vec2.py).

The HuggingFace `Wav2Vec2Model` layout in both variants: the post-norm
"base" stack and the pre-norm `do_stable_layer_norm` one, with the
feature extractor's `feat_extract_norm` "group" (a GroupNorm of one
group per channel after conv0 only, no conv bias) or "layer" (a
LayerNorm and a conv bias after every conv), exact GELU throughout.
The forward, as the JAX package's:

1. each utterance normalised to zero mean and unit variance over its
   valid samples, the pad zeroed;
2. the seven-conv feature extractor (channels first inside, no gradient
   when `freeze_feature_extractor`: its parameters then get none, which
   the optimizers take as zero, as `stop_gradient` gives JAX zero);
3. `fp_layer_norm` → `feature_projection`, the pad frames zeroed;
4. the grouped positional conv, padded (k//2, k//2 − 1) for an even
   kernel (HF trims the trailing frame), added as h + gelu(pos);
5. the transformer stack (every LayerNorm at ε 1e-5), dropout after the
   attention and inside the feed-forward in training only, drawn from an
   explicit generator;
6. `head` → output_dim, the pad frames zeroed, f32, with the output
   lengths of `conv_output_lengths`.

Submodules keep the flax names (`feature_extractor.conv{i}`/`norm{i}`,
`fp_layer_norm`, `feature_projection`, `pos_conv`, `encoder_layer_norm`,
`attn{i}`, `ffn{i}`, `layer_norm{i}`, `final_layer_norm{i}`, `head`), so
speech2text_torch/convert.py maps a flax tree one to one and
speech2text_torch/tools/convert_wav2vec2.py a HuggingFace checkpoint.
Attention and convolutions are plain torch: the JAX package computes them
outside Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masking import make_non_pad_mask
from .layers import Conv, Dense, GroupNorm, LayerNorm, dropout, dtype_of

# the standard wav2vec2 feature-extractor schedule: (dim, kernel, stride)
CONV_SCHEDULE = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                 (512, 3, 2), (512, 2, 2), (512, 2, 2))
LN_EPS = 1e-5


@dataclasses.dataclass
class Wav2Vec2Config:
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 8
    ffn_dim: int = 3072
    output_dim: int = 256
    dropout: float = 0.1
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    freeze_feature_extractor: bool = True
    # HF layout switches: base = ("group", False); large = ("layer", True)
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    pretrained_path: Optional[str] = None
    dtype: str = "float32"


def conv_output_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """The conv stack's frames per utterance of `lengths` samples, int32,
    clamped at 0 (floor division throughout, as JAX's)."""
    out = lengths.to(torch.int32)
    for _, k, s in CONV_SCHEDULE:
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return torch.clamp(out, min=0)


class FeatureExtractor(nn.Module):
    def __init__(self, norm_mode: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_mode = norm_mode == "layer"
        self.dtype = dtype
        c_in = 1
        for i, (dim, k, s) in enumerate(CONV_SCHEDULE):
            self.add_module(f"conv{i}", Conv(c_in, dim, (k,), (s,),
                                             bias=self.layer_mode,
                                             dtype=dtype))
            if self.layer_mode:
                self.add_module(f"norm{i}", LayerNorm(dim, dtype, LN_EPS))
            elif i == 0:
                self.norm0 = GroupNorm(dim, dtype, LN_EPS)
            c_in = dim

    def forward(self, pcm: torch.Tensor) -> torch.Tensor:
        """(B, N) → (B, T, 512)."""
        dt = self.dtype
        h = pcm[:, None, :].to(dt)                   # channels first
        for i, (_, _, s) in enumerate(CONV_SCHEDULE):
            conv = getattr(self, f"conv{i}")
            h = F.conv1d(h, conv.weight.to(dt), None if conv.bias is None
                         else conv.bias.to(dt), stride=s)
            if self.layer_mode:
                h = getattr(self, f"norm{i}")(h.transpose(1, 2)
                                              ).transpose(1, 2)
            elif i == 0:
                h = self.norm0(h)
            h = F.gelu(h)
        return h.transpose(1, 2)


class Wav2Vec2Attention(nn.Module):
    """HF-layout MHA: separate q/k/v/out projections, q scaled before the
    product, padded keys at −1e30, scores and softmax in f32."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.q_proj(x) * (hd ** -0.5)
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = torch.where(pad_mask[:, None, None, :], scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(B, T, D).to(self.dtype)
        return self.out_proj(out)


class Wav2Vec2FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, rate: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = rate
        self.intermediate_dense = Dense(dim, ffn_dim, dtype=dtype)
        self.output_dense = Dense(ffn_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = F.gelu(self.intermediate_dense(x))
        return self.output_dense(dropout(h, self.rate, training, generator))


class Wav2Vec2Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        cfg = self.config = config
        dt = dtype_of(cfg.dtype)
        D = cfg.hidden_dim
        self.feature_extractor = FeatureExtractor(cfg.feat_extract_norm, dt)
        feat = CONV_SCHEDULE[-1][0]
        self.fp_layer_norm = LayerNorm(feat, dt, LN_EPS)
        self.feature_projection = Dense(feat, D, dtype=dt)
        kp = cfg.conv_pos_kernel
        self.pos_pad = (kp // 2, kp // 2 - (1 if kp % 2 == 0 else 0))
        self.pos_conv = Conv(D, D, (kp,), groups=cfg.conv_pos_groups,
                             dtype=dt)
        self.encoder_layer_norm = LayerNorm(D, dt, LN_EPS)
        for i in range(cfg.num_layers):
            self.add_module(f"attn{i}", Wav2Vec2Attention(D, cfg.num_heads,
                                                          dt))
            self.add_module(f"layer_norm{i}", LayerNorm(D, dt, LN_EPS))
            self.add_module(f"ffn{i}", Wav2Vec2FeedForward(
                D, cfg.ffn_dim, cfg.dropout, dt))
            self.add_module(f"final_layer_norm{i}", LayerNorm(D, dt, LN_EPS))
        self.head = Dense(D, cfg.output_dim, dtype=dt)

    def forward(self, pcm: torch.Tensor, sample_lengths: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pcm (B, N) f32, sample_lengths (B,) → (out (B, T', output_dim)
        f32, zero past each length; out_lens (B,) int32)."""
        cfg = self.config
        rate = cfg.dropout
        valid = make_non_pad_mask(sample_lengths, pcm.shape[1]).float()
        n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
        mean = (pcm * valid).sum(dim=1, keepdim=True) / n
        var = ((pcm - mean).square() * valid).sum(dim=1, keepdim=True) / n
        pcm = (pcm - mean) / torch.sqrt(var + 1e-7) * valid

        if cfg.freeze_feature_extractor:
            with torch.no_grad():
                feats = self.feature_extractor(pcm)
        else:
            feats = self.feature_extractor(pcm)
        out_lens = conv_output_lengths(sample_lengths)
        h = self.feature_projection(self.fp_layer_norm(feats))
        pad_mask = make_non_pad_mask(out_lens, h.shape[1])
        h = torch.where(pad_mask[..., None], h, 0.0)

        pos = self.pos_conv(F.pad(h, (0, 0) + self.pos_pad))
        h = h + F.gelu(pos)
        if not cfg.do_stable_layer_norm:
            h = self.encoder_layer_norm(h)
        for i in range(cfg.num_layers):
            attn = getattr(self, f"attn{i}")
            ln, final_ln = (getattr(self, f"layer_norm{i}"),
                            getattr(self, f"final_layer_norm{i}"))
            ffn = getattr(self, f"ffn{i}")
            if cfg.do_stable_layer_norm:          # pre-norm
                h = h + dropout(attn(ln(h), pad_mask), rate, training,
                                generator)
                h = h + ffn(final_ln(h), training, generator)
            else:                                 # post-norm
                a = dropout(attn(h, pad_mask), rate, training, generator)
                h = ln(h + a)
                h = final_ln(h + ffn(h, training, generator))
        if cfg.do_stable_layer_norm:
            h = self.encoder_layer_norm(h)
        out = torch.where(pad_mask[..., None], self.head(h), 0.0)
        return out.float(), out_lens
