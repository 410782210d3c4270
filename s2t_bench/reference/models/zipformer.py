"""Zipformer2 encoder (port of speech2text_tpu/models/zipformer.py), the
training forward the flagship runs: unrolled layers (the `layer{i}`
parameter layout), both `full_dim_bypass` settings, full-context or
chunk-causal attention masks, no training dynamics and no activation
recompute (a config that asks for either raises). In training
(`training=True`) the feedforwards drop out after SwooshL and each
stack's output channels at or above `encoder_unmasked_dim[i]` are zeroed
for a random share of whole utterances, the masks drawn from the
`torch.Generator` the caller passes.

Layouts at the edges are the JAX ones: the frontend takes fbank
(B, T, F) and keeps its conv activations channels-last (B, T, F, C);
attention weights are (B, H, T, T). Every layer's weights come from
`AttentionWeights`, the plain version of kernel B1 on every device
(ops/attn_weights.py).

Dtypes follow flax: parameters are f32; each layer computes in the
config's dtype; BiasNorm normalises in f32; the f32 bypass scales
promote the residual stream to f32 after the first layer, as in the
unrolled JAX form; the encoder output is f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attn_weights import zip_weights
from ..ops.masking import chunk_causal_mask, make_non_pad_mask
from .layers import Conv, Dense, dropout, dtype_of


# ------------------------------------------------------------- primitives
def _softplus0(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(0, x) (F.softplus's threshold changes
    the values)."""
    return torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device),
                           x)


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL(x) = log(1 + e^(x-4)) − 0.08x − 0.035."""
    return _softplus0(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR(x) = log(1 + e^(x-1)) − 0.08x − 0.313261687."""
    return _softplus0(x - 1.0) - 0.08 * x - 0.313261687


class BiasNorm(nn.Module):
    """x / RMS(x − b) · e^s, computed in f32 and cast to `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))
        self.log_scale = nn.Parameter(torch.zeros(()))
        self.dtype = dtype

    def init_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()
            self.log_scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        rms = torch.sqrt(torch.mean(torch.square(x32 - self.bias), dim=-1,
                                    keepdim=True) + 1e-8)
        return ((x32 / rms) * torch.exp(self.log_scale)).to(self.dtype)


class BypassModule(nn.Module):
    """y = x + c·(m(x) − x), c per channel clamped to [min_scale, 1]."""

    def __init__(self, dim: int, min_scale: float = 0.25):
        super().__init__()
        self.bypass_scale = nn.Parameter(torch.full((dim,), 0.5))
        self.min_scale = min_scale

    def init_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.bypass_scale.fill_(0.5)

    def forward(self, x_orig: torch.Tensor,
                x_new: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(self.bypass_scale, self.min_scale, 1.0)
        return x_orig + c * (x_new - x_orig)


def convert_num_channels(x: torch.Tensor, num_channels: int) -> torch.Tensor:
    d = x.shape[-1]
    if num_channels <= d:
        return x[..., :num_channels]
    return F.pad(x, (0, num_channels - d))


class SimpleDownsample(nn.Module):
    """×f time downsample by softmax-weighted averaging of each f-frame
    group; the tail is padded by repeating the last frame."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor
        if factor > 1:
            self.weights = nn.Parameter(torch.zeros(factor))

    def init_parameters(self, g: torch.Generator) -> None:
        if self.factor > 1:
            with torch.no_grad():
                self.weights.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        if f == 1:
            return x
        B, T, D = x.shape
        T2 = -(-T // f)
        pad = T2 * f - T
        if pad:
            x = torch.cat([x, x[:, -1:].expand(B, pad, D)], dim=1)
        rt = torch.promote_types(x.dtype, torch.float32)
        w = torch.softmax(self.weights, dim=0).to(rt)
        return torch.einsum("btfd,f->btd", x.reshape(B, T2, f, D).to(rt), w)


class SimpleUpsample(nn.Module):
    """×f upsample by frame repetition."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor, out_len: int) -> torch.Tensor:
        if self.factor > 1:
            x = torch.repeat_interleave(x, self.factor, dim=1)
        return x[:, :out_len]


# ------------------------------------------------------ frontend (½ rate)
class ConvNeXtBlock(nn.Module):
    """Residual depthwise 7×7 conv block of the subsampling frontend;
    causal (time left-padded by 6) when `causal`."""

    CONTEXT = 6

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 causal: bool = False):
        super().__init__()
        self.causal = causal
        self.dw = Conv(channels, channels, (7, 7), groups=channels,
                       dtype=dtype)
        self.pw1 = Dense(channels, channels * 3, dtype=dtype)
        self.pw2 = Dense(channels * 3, channels, dtype=dtype,
                         init_scale=0.01 ** 2)

    def _h(self, xw: torch.Tensor) -> torch.Tensor:
        """xw (B, T + 6, F, C), time already padded or windowed; the
        frequency axis is padded (3, 3) here."""
        xp = F.pad(xw, (0, 0, 3, 3))
        return self.pw2(swoosh_l(self.pw1(self.dw(xp))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, F, C)
        pad_t = (self.CONTEXT, 0) if self.causal else (3, 3)
        return x + self._h(F.pad(x, (0, 0, 0, 0, *pad_t)))


class Conv2dSubsampling(nn.Module):
    """fbank (B, T, F) → (B, (T−7)//2 − 1, out_dim)."""

    MID_CHANNELS = 32

    def __init__(self, feature_dim: int, out_dim: int,
                 mid_channels: int = MID_CHANNELS,
                 dtype: torch.dtype = torch.float32, causal: bool = False):
        super().__init__()
        C = mid_channels
        self.dtype = dtype
        self.causal = causal
        self.feature_dim, self.mid_channels = feature_dim, C
        self.conv1 = Conv(1, C, (3, 3), dtype=dtype)
        self.conv2 = Conv(C, C, (3, 3), strides=(2, 2), dtype=dtype)
        self.conv3 = Conv(C, C, (3, 3), dtype=dtype)
        self.convnext = ConvNeXtBlock(C, dtype, causal)
        self.out = Dense(self.freq_dim(feature_dim) * C, out_dim,
                         dtype=dtype)
        self.out_norm = BiasNorm(out_dim, dtype)

    @staticmethod
    def freq_dim(feature_dim: int) -> int:
        return ((feature_dim - 2 - 3) // 2 + 1) - 2

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → (B, (T − 9)//2 + 1, F2, C)."""
        h = x[..., None].to(self.dtype)
        h = swoosh_r(self.conv1(h))
        h = swoosh_r(self.conv2(h))
        return swoosh_r(self.conv3(h))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        B, T2, F2, C = h.shape
        return self.out_norm(self.out(h.reshape(B, T2, F2 * C)))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self._head(self.convnext(self._stack(x)))
        out_len = torch.div(lengths.to(torch.int32) - 5, 2,
                            rounding_mode="floor") + 1 - 2
        return h, torch.clamp(out_len, min=0).to(torch.int32)


# ------------------------------------------------------------- attention
class CompactRelPositionalEncoding(nn.Module):
    """Log-compressed relative offsets → Fourier features; row o+max_offset
    of the table is the embedding of query−key offset o. `variant`
    "fourier" (the repo's basis) or "icefall" (the reference's formula)."""

    def __init__(self, pos_dim: int = 48, variant: str = "fourier"):
        super().__init__()
        if variant not in ("fourier", "icefall"):
            raise ValueError(f"unknown pos variant {variant!r}")
        self.pos_dim = pos_dim
        self.variant = variant

    def table(self, max_offset: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
        x = torch.arange(-max_offset, max_offset + 1, dtype=torch.float32,
                         device=device)
        if self.variant == "icefall":
            x = -x
            cl = float(self.pos_dim) ** 0.5
            x_c = cl * torch.sign(x) * (torch.log(torch.abs(x) + cl)
                                        - math.log(cl))
            length_scale = self.pos_dim / (2.0 * math.pi)
            phase = torch.atan(x_c / length_scale)
            freqs = 1.0 + torch.arange(self.pos_dim // 2,
                                       dtype=torch.float32, device=device)
            ang = phase[:, None] * freqs[None, :]
            pe = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
            pe = pe.reshape(x.shape[0], self.pos_dim)
            pe[:, -1] = 1.0
            return pe
        compression = 8.0
        c = torch.sign(x) * torch.log1p(torch.abs(x) / compression) \
            * compression
        d = self.pos_dim // 2
        freqs = torch.exp(torch.arange(d, dtype=torch.float32, device=device)
                          * (-math.log(200.0) / max(d - 1, 1)))
        ang = c[:, None] * freqs[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def forward(self, T: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
        return self.table(T - 1, device)


class AttentionWeights(nn.Module):
    """Shared attention weights of a layer: content + relative-position
    scores → clip → mask → softmax, (B, H, T, T) in the layer's dtype.

    `forward` projects and then calls ops/attn_weights.zip_weights: the
    CUDA kernel on a CUDA tensor, the plain version (the materialized
    path of the JAX `__call__`, with f32 scores) on a CPU tensor."""

    def __init__(self, embed_dim: int, num_heads: int, query_head_dim: int,
                 pos_head_dim: int, pos_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, qd, pd = num_heads, query_head_dim, pos_head_dim
        self.num_heads, self.query_head_dim, self.pos_head_dim = H, qd, pd
        self.dtype = dtype
        self.q_proj = Dense(embed_dim, H * qd, dtype=dtype)
        self.k_proj = Dense(embed_dim, H * qd, dtype=dtype)
        self.qpos_proj = Dense(embed_dim, H * pd, dtype=dtype)
        self.pos_proj = Dense(pos_dim, H * pd, bias=False, dtype=dtype)

    def project(self, x: torch.Tensor, pos_emb: torch.Tensor):
        """(q, k, qp, p) in the JAX layouts (B,T,H,qd), (B,T,H,qd),
        (B,T,H,pd), (2T−1,H,pd)."""
        B, T, _ = x.shape
        H, qd, pd = self.num_heads, self.query_head_dim, self.pos_head_dim
        q = self.q_proj(x).reshape(B, T, H, qd)
        k = self.k_proj(x).reshape(B, T, H, qd)
        qp = self.qpos_proj(x).reshape(B, T, H, pd)
        p = self.pos_proj(pos_emb).reshape(-1, H, pd)
        return q, k, qp, p

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, qp, p = self.project(x, pos_emb)
        return zip_weights(q, k, qp, p, attn_mask, w_dtype=self.dtype)


class SelfAttention(nn.Module):
    """Value path reusing the layer's attention weights."""

    def __init__(self, embed_dim: int, num_heads: int, value_head_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.value_head_dim = num_heads, value_head_dim
        self.dtype = dtype
        self.v_proj = Dense(embed_dim, num_heads * value_head_dim,
                            dtype=dtype)
        self.out_proj = Dense(num_heads * value_head_dim, embed_dim,
                              dtype=dtype, init_scale=0.05 ** 2)

    def _attend(self, attn_weights: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """weights (B, H, Tq, Tk), projected values v (B, Tk, H·vd)."""
        B, H, Tq, Tk = attn_weights.shape
        v = v.reshape(B, Tk, H, self.value_head_dim).transpose(1, 2)
        out = torch.matmul(attn_weights.to(v.dtype), v)    # (B, H, Tq, vd)
        out = out.transpose(1, 2).reshape(B, Tq, -1).to(self.dtype)
        return self.out_proj(out)

    def forward(self, x: torch.Tensor,
                attn_weights: torch.Tensor) -> torch.Tensor:
        return self._attend(attn_weights, self.v_proj(x))


class NonlinAttention(nn.Module):
    """Gated single-head attention: in_proj → (s, a, b); values a·tanh(s)
    attended by the first head's weights, then gated by b."""

    def __init__(self, embed_dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.in_proj = Dense(embed_dim, 3 * hidden, dtype=dtype)
        self.out_proj = Dense(hidden, embed_dim, dtype=dtype,
                              init_scale=0.05 ** 2)

    def forward(self, x: torch.Tensor,
                attn_weights_1head: torch.Tensor) -> torch.Tensor:
        s, a, b = self.in_proj(x).chunk(3, dim=-1)
        v = a * torch.tanh(s)
        out = torch.matmul(attn_weights_1head.to(v.dtype), v)
        return self.out_proj(b * out.to(self.dtype))


class FeedforwardModule(nn.Module):
    def __init__(self, dim: int, ff_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.in_ = Dense(dim, ff_dim, dtype=dtype)
        self.out = Dense(ff_dim, dim, dtype=dtype, init_scale=0.1 ** 2)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(swoosh_l(self.in_(x)), self.dropout, training, generator)
        return self.out(h)


class ConvolutionModule(nn.Module):
    """pointwise GLU → depthwise conv (left-padded when causal) → SwooshR
    → pointwise."""

    def __init__(self, dim: int, kernel_size: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.causal = kernel_size, causal
        self.in_proj = Dense(dim, 2 * dim, dtype=dtype)
        self.dw = Conv(dim, dim, (kernel_size,), groups=dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype, init_scale=0.05 ** 2)

    def forward(self, x: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        h = F.glu(self.in_proj(x), dim=-1)
        h = torch.where(pad_mask[..., None], h, 0.0)
        K = self.kernel_size
        left = K - 1 if self.causal else (K - 1) // 2
        h = F.pad(h, (0, 0, left, K - 1 - left))
        return self.out_proj(swoosh_r(self.dw(h)))


# ----------------------------------------------------------------- layer
class Zipformer2EncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, ff_dim: int, num_heads: int,
                 query_head_dim: int, value_head_dim: int,
                 pos_head_dim: int, pos_dim: int, kernel_size: int,
                 causal: bool, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        D = embed_dim
        self.dtype = dtype
        self.attn_weights = AttentionWeights(D, num_heads, query_head_dim,
                                             pos_head_dim, pos_dim, dtype)
        self.ff1 = FeedforwardModule(D, ff_dim * 3 // 4, dtype, dropout)
        self.nonlin_attn = NonlinAttention(D, D * 3 // 4, dtype)
        self.self_attn1 = SelfAttention(D, num_heads, value_head_dim, dtype)
        self.conv1 = ConvolutionModule(D, kernel_size, causal, dtype)
        self.ff2 = FeedforwardModule(D, ff_dim, dtype, dropout)
        self.bypass_mid = BypassModule(D)
        self.self_attn2 = SelfAttention(D, num_heads, value_head_dim, dtype)
        self.conv2 = ConvolutionModule(D, kernel_size, causal, dtype)
        self.ff3 = FeedforwardModule(D, ff_dim * 5 // 4, dtype, dropout)
        self.norm = BiasNorm(D, dtype)
        self.bypass = BypassModule(D)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                pad_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        attn_w = self.attn_weights(x, pos_emb, attn_mask)
        src = x
        x = x + self.ff1(x, training, generator)
        x = x + self.nonlin_attn(x, attn_w[:, 0])
        x = x + self.self_attn1(x, attn_w)
        x = x + self.conv1(x, pad_mask)
        x = x + self.ff2(x, training, generator)
        x = self.bypass_mid(src, x)
        x = x + self.self_attn2(x, attn_w)
        x = x + self.conv2(x, pad_mask)
        x = x + self.ff3(x, training, generator)
        x = self.norm(x)
        return self.bypass(src, x)


class Zipformer2Stack(nn.Module):
    """One resolution stack: downsample → layers → upsample → bypass."""

    def __init__(self, input_dim: int, num_layers: int, downsample: int,
                 embed_dim: int, ff_dim: int, num_heads: int,
                 query_head_dim: int, value_head_dim: int,
                 pos_head_dim: int, pos_dim: int,
                 kernel_size: int, causal: bool,
                 dtype: torch.dtype = torch.float32,
                 pos_variant: str = "fourier",
                 full_dim_bypass: bool = False, dropout: float = 0.1):
        super().__init__()
        self.downsample_factor = downsample
        self.embed_dim = embed_dim
        self.full_dim_bypass = full_dim_bypass
        self.layers = nn.ModuleList(
            Zipformer2EncoderLayer(embed_dim, ff_dim, num_heads,
                                   query_head_dim, value_head_dim,
                                   pos_head_dim, pos_dim, kernel_size,
                                   causal, dtype, dropout)
            for _ in range(num_layers))
        self.downsample = SimpleDownsample(downsample)
        self.up = SimpleUpsample(downsample)
        self.penc = CompactRelPositionalEncoding(pos_dim, pos_variant)
        # flax sizes the scale by the channels it bypasses
        self.stack_bypass = BypassModule(
            embed_dim if full_dim_bypass else min(input_dim, embed_dim))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                attn_mask_fn, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        T = x.shape[1]
        ds = self.downsample_factor
        x_orig = x
        x = self.downsample(convert_num_channels(x, self.embed_dim))
        ds_len = torch.div(lengths + ds - 1, ds, rounding_mode="floor")
        Td = x.shape[1]
        pad_mask = make_non_pad_mask(ds_len, Td)
        attn_mask = attn_mask_fn(Td, ds, pad_mask)
        pos_emb = self.penc(Td, x.device)
        for layer in self.layers:
            x = layer(x, pos_emb, pad_mask, attn_mask, training, generator)
        x = self.up(x, T)
        x = torch.where(make_non_pad_mask(lengths, T)[..., None], x, 0.0)
        if self.full_dim_bypass:
            return self.stack_bypass(
                convert_num_channels(x_orig, self.embed_dim), x)
        return self._common_bypass(x_orig, x)

    def _common_bypass(self, x_orig: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
        d = min(x_orig.shape[-1], self.embed_dim)
        out = self.stack_bypass(x_orig[..., :d], x[..., :d])
        if self.embed_dim > d:
            out = torch.cat([out, x[..., d:].to(out.dtype)], dim=-1)
        return out


# ------------------------------------------------------------------ model
@dataclasses.dataclass
class Zipformer2Config:
    """The fields the training forward reads. The chunk and left-context
    lists are read by the task's chunk sampling (step.sample_chunk).
    `dynamics` and `remat` are read only to refuse them. `from_config`
    ignores the kernel switches (use_flash_attn, flash_min_batch,
    score_dtype): the weights are the plain version's, with f32 scores,
    as the port's kernel computes them."""
    feature_dim: int = 80
    downsampling_factor: Tuple[int, ...] = (1, 2, 4, 8, 4, 2)
    num_encoder_layers: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)
    feedforward_dim: Tuple[int, ...] = (512, 768, 768, 768, 768, 768)
    encoder_dim: Tuple[int, ...] = (192, 256, 256, 256, 256, 256)
    encoder_unmasked_dim: Tuple[int, ...] = (192, 192, 192, 192, 192, 192)
    num_heads: Tuple[int, ...] = (4, 4, 4, 8, 4, 4)
    query_head_dim: int = 32
    value_head_dim: int = 12
    pos_head_dim: int = 4
    pos_dim: int = 48
    cnn_module_kernel: Tuple[int, ...] = (31, 31, 15, 15, 15, 31)
    causal: bool = False
    chunk_size: Tuple[int, ...] = (-1,)
    left_context_frames: Tuple[int, ...] = (-1,)
    output_downsampling_factor: int = 2
    dropout: float = 0.1
    feature_mask_dropout_prob: float = 0.15
    dtype: str = "float32"
    dynamics: bool = False
    pos_variant: str = "fourier"
    full_dim_bypass: bool = False
    remat: bool = False
    remat_policy: str = "full"

    @classmethod
    def from_config(cls, cfg: dict) -> "Zipformer2Config":
        cfg = dict(cfg)
        for k in ("downsampling_factor", "num_encoder_layers",
                  "feedforward_dim", "encoder_dim", "encoder_unmasked_dim",
                  "num_heads", "cnn_module_kernel", "chunk_size",
                  "left_context_frames"):
            if k in cfg and isinstance(cfg[k], list):
                cfg[k] = tuple(cfg[k])
        valid = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in valid})


class Zipformer2(nn.Module):
    def __init__(self, config: Zipformer2Config):
        super().__init__()
        cfg = self.config = config
        if cfg.dynamics or cfg.remat:
            raise ValueError("the reference has no training dynamics and "
                             "no activation recompute")
        dt = dtype_of(cfg.dtype)
        self.embed = Conv2dSubsampling(cfg.feature_dim, cfg.encoder_dim[0],
                                       dtype=dt, causal=cfg.causal)
        self.stacks = nn.ModuleList(
            Zipformer2Stack(
                input_dim=cfg.encoder_dim[max(i - 1, 0)],
                num_layers=cfg.num_encoder_layers[i],
                downsample=cfg.downsampling_factor[i],
                embed_dim=cfg.encoder_dim[i],
                ff_dim=cfg.feedforward_dim[i],
                num_heads=cfg.num_heads[i],
                query_head_dim=cfg.query_head_dim,
                value_head_dim=cfg.value_head_dim,
                pos_head_dim=cfg.pos_head_dim,
                pos_dim=cfg.pos_dim,
                kernel_size=cfg.cnn_module_kernel[i],
                causal=cfg.causal,
                dtype=dt,
                pos_variant=cfg.pos_variant,
                full_dim_bypass=cfg.full_dim_bypass,
                dropout=cfg.dropout)
            for i in range(len(cfg.encoder_dim)))
        self.out_downsample = SimpleDownsample(
            cfg.output_downsampling_factor)

    def _recombine(self, outputs: List[torch.Tensor]) -> torch.Tensor:
        """Each channel range comes from the last stack wide enough to
        produce it."""
        dims = list(self.config.encoder_dim)
        pieces = []
        cur = 0
        while cur < max(dims):
            j = [i for i, d in enumerate(dims) if d > cur][-1]
            pieces.append(outputs[j][..., cur:dims[j]])
            cur = dims[j]
        rt = pieces[0].dtype
        for piece in pieces[1:]:
            rt = torch.promote_types(rt, piece.dtype)
        return torch.cat([piece.to(rt) for piece in pieces], dim=-1)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                chunk_size: int = -1, left_context_chunks: int = -1,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`training` turns on dropout and the feature mask, drawn from
        `generator` (on the input's device)."""
        x, lens = self.embed(feats, lengths)
        return self.encode_embedded(x, lens, chunk_size, left_context_chunks,
                                    training, generator)

    def encode_embedded(self, x: torch.Tensor, lens: torch.Tensor,
                        chunk_size: int = -1, left_context_chunks: int = -1,
                        training: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stacks on post-subsampling features (B, T, dim0)."""
        cfg = self.config
        keep = None
        if training and cfg.feature_mask_dropout_prob > 0:
            # one draw per utterance, kept for every stack
            keep = torch.rand((x.shape[0], 1, 1), generator=generator,
                              device=x.device) \
                < 1.0 - cfg.feature_mask_dropout_prob

        def attn_mask_fn(Td: int, ds_factor: int, pad_mask: torch.Tensor):
            mask = pad_mask[:, None, :] & pad_mask[:, :, None]
            if not cfg.causal:
                return mask
            cs = max(chunk_size // ds_factor, 1) if chunk_size > 0 else -1
            cm = chunk_causal_mask(Td, cs, left_context_chunks,
                                   device=pad_mask.device)
            return mask & cm[None]

        outputs = []
        for i, stack in enumerate(self.stacks):
            x = stack(x, lens, attn_mask_fn, training, generator)
            if keep is not None:
                d_idx = torch.arange(x.shape[-1], device=x.device)
                x = x * torch.where(
                    d_idx[None, None, :] < cfg.encoder_unmasked_dim[i], 1.0,
                    keep.to(x.dtype))
            outputs.append(x)
        out = self.out_downsample(self._recombine(outputs))
        f = cfg.output_downsampling_factor
        out_lens = torch.div(lens + f - 1, f, rounding_mode="floor")
        out = torch.where(make_non_pad_mask(out_lens, out.shape[1])[..., None],
                          out, 0.0)
        return out.float(), out_lens.to(torch.int32)
