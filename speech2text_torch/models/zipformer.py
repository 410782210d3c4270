"""Zipformer2 encoder (port of speech2text_tpu/models/zipformer.py).

Covers the serving forward and the training forward with
`dynamics=False`: unrolled layers (the `layer{i}` parameter layout), both
`full_dim_bypass` settings, full-context or chunk-causal attention masks.
In training (`training=True`) the feedforwards drop out after SwooshL and
each stack's output channels at or above `encoder_unmasked_dim[i]` are
zeroed for a random share of whole utterances, the masks drawn from the
`torch.Generator` the caller passes. With `dynamics=True` training also
runs icefall's training dynamics as the JAX package does: per-sequence
skips of the attention, convolution and feedforward modules and of the
layer's bypass, constant attention, bypass scales clamped from below by
a schedule, and balancers and whitening (ops/regularizers.py) at the
JAX placements, every rate and limit a `ScheduledFloat` of the global
`step` (1e9 when none is given), evaluated on the host. Evaluation,
serving and streaming do not change with it.

Activation recompute (`remat`, `remat_policy`, as JAX's `nn.remat` of
each layer): in training with gradients on, each layer runs under
`torch.utils.checkpoint` (non-reentrant), inside the layer's own forward
so that an FSDP-wrapped layer's hooks stay outside it. "full" keeps the
layer's inputs only and recomputes the layer in the backward pass
(kernel B1 launches again); "dots" keeps every matrix product's output
and B1's weights (JAX's `dots_saveable` plus the named "attn_weights")
and recomputes the rest, so B1 does not launch again. The recompute
draws the same dropout masks: the layer's dynamics draws are taken
before the checkpoint and handed in, and the recompute replays the
caller's generator from its state at the layer's start, then puts it
back. Loss and gradients equal the run without recompute bit for bit.
The `scan_layers` layout is a checkpoint layout only (convert.py
unstacks it); it changes no value and the forward ignores it.

True streaming of a causal config (`Zipformer2.init_streaming_state`,
`streaming_prime`, `streaming_step`): the frontend carries 8 raw fbank
frames and 6 ConvNeXt sub-frames, each layer six caches (attention keys,
the nonlinear-attention values, both attention values, both convolution
contexts). Its outputs equal the chunk-masked forward's from frame 0.
The streaming attention weights of a chunk against its cache
(`AttentionWeights.step`) are plain torch on every device, as they are
jnp code in JAX: kernel B1 takes square (T, T) weights only.

Layouts at the edges are the JAX ones: the frontend takes fbank
(B, T, F) and keeps its conv activations channels-last (B, T, F, C);
attention weights are (B, H, T, T). Every layer's weights come from
`AttentionWeights`, which launches the CUDA kernel csrc/attn_weights.cu
on a CUDA tensor (at every batch size: no TPU crossover carries over)
and its plain version on a CPU tensor.

Dtypes follow flax: parameters are f32; each layer computes in the
config's dtype; BiasNorm normalises in f32; the f32 bypass scales
promote the residual stream to f32 after the first layer, as in the
unrolled JAX form; the encoder output is f32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attn_weights import NEG, zip_weights
from ..ops.masking import chunk_causal_mask, make_non_pad_mask
from ..ops.regularizers import (ScheduledFloat, balancer,
                                limit_param_value, whiten,
                                whitening_schedule)
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
    """y = x + c·(m(x) − x), c per channel clamped to [min_scale, 1]; in
    the training dynamics clamped to [scale_min, 1] straight through, and
    times the per-sequence `skip_mask` (B, 1, 1)."""

    def __init__(self, dim: int, min_scale: float = 0.25):
        super().__init__()
        self.bypass_scale = nn.Parameter(torch.full((dim,), 0.5))
        self.min_scale = min_scale

    def init_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.bypass_scale.fill_(0.5)

    def forward(self, x_orig: torch.Tensor, x_new: torch.Tensor,
                scale_min: Optional[float] = None,
                skip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if scale_min is None:
            c = torch.clamp(self.bypass_scale, self.min_scale, 1.0)
        else:
            c = limit_param_value(self.bypass_scale, scale_min, 1.0)
        if skip_mask is not None:
            c = c * skip_mask
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

    def step(self, window: torch.Tensor) -> torch.Tensor:
        """Causal streaming: window (B, CONTEXT + c, F, C), the cached
        sub-frames followed by c new ones → the c new frames' outputs,
        equal to the causal `forward` on the whole stream."""
        return window[:, self.CONTEXT:] + self._h(window)


class Conv2dSubsampling(nn.Module):
    """fbank (B, T, F) → (B, (T−7)//2 − 1, out_dim).

    Streaming (causal only): the conv stack sees 9 raw frames at stride 2,
    so `stream_prime` takes the first 2c + RAW_TAIL raw frames and
    `stream_step` 2c raw frames per chunk, each giving c sub-frames; the
    cache carries the last RAW_TAIL raw frames (f32) and CONTEXT ConvNeXt
    input sub-frames (model dtype). The zero `sub` cache stands in for the
    causal forward's left padding, so the output is exact from frame 0."""

    RAW_TAIL = 8
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

    # ------------------------------------------------------------ streaming
    def init_cache(self, batch_size: int,
                   device: torch.device | str = "cpu") -> Dict[str, Any]:
        if not self.causal:
            raise ValueError("exact streaming requires the causal ConvNeXt")
        F2 = self.freq_dim(self.feature_dim)
        return {
            "raw_tail": torch.zeros((batch_size, self.RAW_TAIL,
                                     self.feature_dim), device=device),
            "sub": torch.zeros((batch_size, ConvNeXtBlock.CONTEXT, F2,
                                self.mid_channels), dtype=self.dtype,
                               device=device),
        }

    def stream_prime(self, feats: torch.Tensor, cache: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """First chunk: (B, 2c + RAW_TAIL, F) raw frames → (B, c,
        out_dim)."""
        win = torch.cat([cache["sub"], self._stack(feats)], dim=1)
        out = self._head(self.convnext.step(win))
        return out, {"raw_tail": feats[:, -self.RAW_TAIL:],
                     "sub": win[:, -ConvNeXtBlock.CONTEXT:]}

    def stream_step(self, feats: torch.Tensor, cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Steady state: (B, 2c, F) raw frames after the cached tail →
        (B, c, out_dim)."""
        return self.stream_prime(
            torch.cat([cache["raw_tail"], feats], dim=1), cache)


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

    def step(self, x_chunk: torch.Tensor, pos_table: torch.Tensor,
             cached_k: torch.Tensor, valid_cache: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming: queries are the chunk (C), keys the cache (L) then
        the chunk. cached_k (B, L, H·qd) projected keys, filled from the
        right; `valid_cache` the count of real cached frames (a host int,
        or a 0-dim tensor in an exported program);
        pos_table the embeddings of offsets −(L+C−1)..L+C−1
        (CompactRelPositionalEncoding.table(L + C − 1)). Returns (weights
        (B, H, C, L+C) in the layer's dtype, the new key cache).

        Plain torch on every device, as JAX's `step` is jnp code: kernel
        B1 takes square (T, T) weights and a (2T−1)-row table only. Scores
        in f32, clipped at ±100, unfilled cache slots masked with −1e30,
        f32 softmax, then the cast."""
        B, C, _ = x_chunk.shape
        H, qd, pd = self.num_heads, self.query_head_dim, self.pos_head_dim
        L = cached_k.shape[1]
        q = self.q_proj(x_chunk).reshape(B, C, H, qd)
        keys = torch.cat([cached_k, self.k_proj(x_chunk)], dim=1)
        k = keys.reshape(B, L + C, H, qd)
        qp = self.qpos_proj(x_chunk).reshape(B, C, H, pd)
        p = self.pos_proj(pos_table).reshape(-1, H, pd)
        q, k, qp, p = (t.float() for t in (q, k, qp, p))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(qd)
        # query i sits at L + i, key s at s: offset L + i − s, table row
        # offset + max_offset
        rows = p.shape[0]
        i = torch.arange(C, device=q.device)[:, None]
        s = torch.arange(L + C, device=q.device)[None, :]
        idx = torch.clamp(L + i - s + (rows - 1) // 2, 0, rows - 1)
        rel = torch.einsum("bthd,rhd->bhtr", qp, p)
        scores = scores + torch.gather(
            rel, 3, idx.expand(B, H, C, L + C)) / math.sqrt(pd)
        scores = scores.clamp(-100.0, 100.0)
        if isinstance(valid_cache, torch.Tensor):
            # an exported program carries the count as a tensor (JAX's
            # int32 `processed`): the same mask, computed on the device
            unfilled = L - torch.clamp(valid_cache, max=L)
            scores = torch.where(s < unfilled, NEG, scores)
        else:
            unfilled = L - min(int(valid_cache), L)
            if unfilled:
                scores[..., :unfilled] = NEG
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        return weights, keys[:, keys.shape[1] - L:]


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

    def step(self, x_chunk: torch.Tensor, attn_weights: torch.Tensor,
             cached_v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """weights (B, H, C, L+C), cached_v (B, L, H·vd) → (out, the last
        L values)."""
        v = torch.cat([cached_v, self.v_proj(x_chunk)], dim=1)
        return self._attend(attn_weights, v), \
            v[:, v.shape[1] - cached_v.shape[1]:]


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

    def forward(self, x: torch.Tensor, attn_weights_1head: torch.Tensor,
                dyn_step: Optional[float] = None) -> torch.Tensor:
        """`dyn_step`, the global step in the training dynamics: a
        balancer on the sigmoid branch s, whitening of a and of the
        output, with their scheduled limits."""
        s, a, b = self.in_proj(x).chunk(3, dim=-1)
        if dyn_step is not None:
            s = balancer(
                s, ScheduledFloat((0.0, 0.25), (20000.0, 0.05))(dyn_step),
                ScheduledFloat((0.0, 0.75), (20000.0, 0.95))(dyn_step),
                min_abs=0.5, max_abs=5.0,
                prob=ScheduledFloat((0.0, 0.5), (8000.0, 0.125))(dyn_step))
            a = whiten(a, whitening_schedule(5.0)(dyn_step), 0.01, 0.25)
        v = a * torch.tanh(s)
        out = torch.matmul(attn_weights_1head.to(v.dtype), v)
        out = self.out_proj(b * out.to(self.dtype))
        if dyn_step is not None:
            out = whiten(out, whitening_schedule(5.0, 3.0)(dyn_step), 0.01,
                         0.25)
        return out

    def step(self, x_chunk: torch.Tensor, attn_weights_1head: torch.Tensor,
             cached_v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """weights (B, C, L+C), cached_v (B, L, hidden) → (out, the last L
        values)."""
        s, a, b = self.in_proj(x_chunk).chunk(3, dim=-1)
        v = torch.cat([cached_v, a * torch.tanh(s)], dim=1)
        out = torch.matmul(attn_weights_1head.to(v.dtype), v)
        return self.out_proj(b * out.to(self.dtype)), \
            v[:, v.shape[1] - cached_v.shape[1]:]


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

    def step(self, x_chunk: torch.Tensor, cache: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal streaming: cache (B, K−1, dim) post-GLU left context →
        (out, the new cache)."""
        h = F.glu(self.in_proj(x_chunk), dim=-1)
        full = torch.cat([cache, h], dim=1)
        return self.out_proj(swoosh_r(self.dw(full))), \
            full[:, full.shape[1] - (self.kernel_size - 1):]


# --------------------------------------------------------------- recompute
REMAT_POLICIES = ("full", "dots")


@functools.lru_cache(maxsize=None)
def _dots_saved() -> frozenset:
    """The ops whose outputs "dots" keeps: the matrix products that
    `nn.Linear`, `Dense`, `@` and the einsums lower to (JAX's
    dots_saveable), and kernel B1's custom op (JAX's
    save_only_these_names("attn_weights"))."""
    aten = torch.ops.aten
    return frozenset((aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default,
                      torch.ops.speech2text_torch.attn_weights.default))


def _dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if func in _dots_saved() \
        else CheckpointPolicy.PREFER_RECOMPUTE


def recomputed(policy: str, fn: Callable[..., torch.Tensor],
               generator: Optional[torch.Generator], *args) -> torch.Tensor:
    """`fn(*args)` under non-reentrant activation checkpointing with
    `policy` ("full" or "dots"). `checkpoint` restores only the default
    generators, so the recompute replays `generator` from its state at
    this call and then puts back the state it found: the recompute draws
    the forward's masks, and the caller's generator moves on once."""
    state = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or generator is None:
            return fn(*a)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(run, *args, use_reentrant=False, **kw)


# ----------------------------------------------------------------- layer
NO_STEP = 1e9   # the step of the schedules when none is given (JAX's)


def sample_layer_draws(batch_size: int, const_attn: float,
                       generator: Optional[torch.Generator],
                       device: torch.device | str) -> Dict[str, torch.Tensor]:
    """A dynamics layer's seven draws: "keep_u" (6, B, 1, 1) uniforms for
    the per-sequence keeps of attention, conv1, conv2, ff2, ff3 and the
    bypass (kept where u ≥ the skip rate), "const" a 0-d bool, constant
    attention with probability `const_attn`."""
    keep_u = torch.rand((6, batch_size, 1, 1), generator=generator,
                        device=device)
    const = torch.rand((), generator=generator, device=device) < const_attn
    return {"keep_u": keep_u, "const": const}


class LayerDynamics:
    """The schedules of a layer's training dynamics at `step`
    (zipformer.py:719-734 of the JAX package), as host floats."""

    def __init__(self, step: float):
        self.attn_skip = ScheduledFloat((0.0, 0.2), (4000.0, 0.05),
                                        (16000.0, 0.0))(step)
        self.conv_skip = self.attn_skip
        self.const_attn = ScheduledFloat((0.0, 0.25), (4000.0, 0.025))(step)
        self.ff2_skip = ScheduledFloat((0.0, 0.1), (4000.0, 0.01),
                                       (50000.0, 0.0))(step)
        self.ff3_skip = self.ff2_skip
        self.bypass_skip = ScheduledFloat((0.0, 0.5), (4000.0, 0.02))(step)
        self.bypass_min = ScheduledFloat((0.0, 0.9), (20000.0, 0.2))(step)
        self.bal_prob = ScheduledFloat((0.0, 0.5), (8000.0, 0.125))(step)
        self.na_min_abs = ScheduledFloat((0.0, 0.004), (4000.0, 0.02))(step)
        self.ff2_min_abs = ScheduledFloat((0.0, 0.0), (4000.0, 0.1))(step)
        self.ff3_min_abs = ScheduledFloat((0.0, 0.0), (4000.0, 0.2))(step)
        self.whiten_limit = whitening_schedule(4.0, 3.0)(step)

    def keep_masks(self, draws: Dict[str, torch.Tensor],
                   dtype: torch.dtype) -> List[torch.Tensor]:
        """The six (B, 1, 1) keep masks in `dtype`: no 1/(1−p) rescale."""
        rates = (self.attn_skip, self.conv_skip, self.conv_skip,
                 self.ff2_skip, self.ff3_skip, self.bypass_skip)
        return [(u >= r).to(dtype) for u, r in zip(draws["keep_u"], rates)]


class Zipformer2EncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, ff_dim: int, num_heads: int,
                 query_head_dim: int, value_head_dim: int,
                 pos_head_dim: int, pos_dim: int, kernel_size: int,
                 causal: bool, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1, dynamics: bool = False,
                 remat: Optional[str] = None):
        super().__init__()
        D = embed_dim
        self.dtype = dtype
        self.dynamics = dynamics
        # "full" / "dots": recompute in training (`recomputed`); None: off
        self.remat = remat
        # the draws of the next dynamics forward in place of sampled ones
        # (JAX's, in the parity tests); consumed by that forward
        self.given_draws: Optional[Dict[str, torch.Tensor]] = None
        self.cache_dims = {"key": num_heads * query_head_dim,
                           "nonlin": D * 3 // 4,
                           "val1": num_heads * value_head_dim,
                           "val2": num_heads * value_head_dim,
                           "conv1": D, "conv2": D}
        self.kernel_size = kernel_size
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
                generator: Optional[torch.Generator] = None,
                step: Optional[float] = None) -> torch.Tensor:
        draws = None
        if self.dynamics and training:
            step = NO_STEP if step is None else float(step)
            draws = self.given_draws
            self.given_draws = None
            if draws is None:
                draws = sample_layer_draws(
                    x.shape[0], LayerDynamics(step).const_attn, generator,
                    x.device)
        if self.remat and training and torch.is_grad_enabled():
            return recomputed(self.remat, self._forward, generator, x,
                              pos_emb, pad_mask, attn_mask, training,
                              generator, step, draws)
        return self._forward(x, pos_emb, pad_mask, attn_mask, training,
                             generator, step, draws)

    def _forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                 pad_mask: torch.Tensor, attn_mask: Optional[torch.Tensor],
                 training: bool, generator: Optional[torch.Generator],
                 step: Optional[float],
                 draws: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The layer, given the dynamics draws (training with dynamics)."""
        if draws is not None:
            return self._dynamics_forward(x, pos_emb, pad_mask, attn_mask,
                                          generator, step, draws)
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

    def _dynamics_forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                          pad_mask: torch.Tensor,
                          attn_mask: Optional[torch.Tensor],
                          generator: Optional[torch.Generator],
                          step: float, draws: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        """The training forward with the dynamics at `step` and the
        layer's `draws` (zipformer.py:708-811 of the JAX package)."""
        dyn = LayerDynamics(step)
        m_attn, m_conv1, m_conv2, m_ff2, m_ff3, m_bypass = \
            dyn.keep_masks(draws, x.dtype)
        attn_w = self.attn_weights(x, pos_emb, attn_mask)
        na_w = attn_w[:, 0]
        # constant attention: uniform weights over the allowed keys
        wc = (na_w > 0).to(na_w.dtype)
        wc = wc / torch.clamp(wc.sum(-1, keepdim=True), min=1e-9)
        na_w = torch.where(draws["const"].to(na_w.device), wc, na_w)
        src = x
        x = x + self.ff1(x, True, generator)
        na = self.nonlin_attn(x, na_w, dyn_step=step)
        na = balancer(na, 0.3, 0.7, min_abs=dyn.na_min_abs, prob=0.05)
        x = x + na * m_attn
        x = x + self.self_attn1(x, attn_w) * m_attn
        x = x + self.conv1(x, pad_mask) * m_conv1
        f2 = balancer(self.ff2(x, True, generator), 0.3, 0.7,
                      min_abs=dyn.ff2_min_abs, max_abs=2.0, prob=0.05)
        x = x + f2 * m_ff2
        x = self.bypass_mid(src, x, scale_min=dyn.bypass_min)
        x = x + self.self_attn2(x, attn_w) * m_attn
        x = x + self.conv2(x, pad_mask) * m_conv2
        f3 = balancer(self.ff3(x, True, generator), 0.3, 0.7,
                      min_abs=dyn.ff3_min_abs, max_abs=4.0, prob=0.05)
        x = x + f3 * m_ff3
        x = balancer(x, 0.45, 0.55, min_abs=0.2, max_abs=4.0,
                     prob=dyn.bal_prob)
        x = self.norm(x)
        x = self.bypass(src, x, scale_min=dyn.bypass_min,
                        skip_mask=m_bypass)
        x = balancer(x, 0.45, 0.55, min_abs=0.1, max_abs=4.0,
                     prob=dyn.bal_prob)
        return whiten(x, dyn.whiten_limit, 0.01, 0.25)

    # ------------------------------------------------------------ streaming
    def init_cache(self, batch_size: int, left: int,
                   device: torch.device | str = "cpu"
                   ) -> Dict[str, torch.Tensor]:
        """The six caches: `left` frames of keys, nonlinear-attention and
        both attention values, K−1 frames of both convolutions' context."""
        return {name: torch.zeros(
            (batch_size, self.kernel_size - 1 if name.startswith("conv")
             else left, dim), dtype=self.dtype, device=device)
            for name, dim in self.cache_dims.items()}

    def streaming_step(self, x: torch.Tensor, pos_table: torch.Tensor,
                       cache: Dict[str, torch.Tensor], valid_cache: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, C, D) chunk → (out, new caches), in `forward`'s order;
        equal to `forward` under a chunk mask with this left context."""
        attn_w, key = self.attn_weights.step(x, pos_table, cache["key"],
                                             valid_cache)
        src = x
        x = x + self.ff1(x)
        out, nonlin = self.nonlin_attn.step(x, attn_w[:, 0], cache["nonlin"])
        x = x + out
        out, val1 = self.self_attn1.step(x, attn_w, cache["val1"])
        x = x + out
        out, conv1 = self.conv1.step(x, cache["conv1"])
        x = x + out
        x = x + self.ff2(x)
        x = self.bypass_mid(src, x)
        out, val2 = self.self_attn2.step(x, attn_w, cache["val2"])
        x = x + out
        out, conv2 = self.conv2.step(x, cache["conv2"])
        x = x + out
        x = x + self.ff3(x)
        x = self.norm(x)
        return self.bypass(src, x), {
            "key": key, "nonlin": nonlin, "val1": val1, "val2": val2,
            "conv1": conv1, "conv2": conv2}


class Zipformer2Stack(nn.Module):
    """One resolution stack: downsample → layers → upsample → bypass."""

    def __init__(self, input_dim: int, num_layers: int, downsample: int,
                 embed_dim: int, ff_dim: int, num_heads: int,
                 query_head_dim: int, value_head_dim: int,
                 pos_head_dim: int, pos_dim: int,
                 kernel_size: int, causal: bool,
                 dtype: torch.dtype = torch.float32,
                 pos_variant: str = "fourier",
                 full_dim_bypass: bool = False, dropout: float = 0.1,
                 dynamics: bool = False, remat: Optional[str] = None):
        super().__init__()
        self.downsample_factor = downsample
        self.embed_dim = embed_dim
        self.full_dim_bypass = full_dim_bypass
        self.dynamics = dynamics
        self.layers = nn.ModuleList(
            Zipformer2EncoderLayer(embed_dim, ff_dim, num_heads,
                                   query_head_dim, value_head_dim,
                                   pos_head_dim, pos_dim, kernel_size,
                                   causal, dtype, dropout, dynamics,
                                   remat)
            for _ in range(num_layers))
        self.downsample = SimpleDownsample(downsample)
        self.up = SimpleUpsample(downsample)
        self.penc = CompactRelPositionalEncoding(pos_dim, pos_variant)
        # flax sizes the scale by the channels it bypasses
        self.stack_bypass = BypassModule(
            embed_dim if full_dim_bypass else min(input_dim, embed_dim))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                attn_mask_fn, training: bool = False,
                generator: Optional[torch.Generator] = None,
                step: Optional[float] = None) -> torch.Tensor:
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
            x = layer(x, pos_emb, pad_mask, attn_mask, training, generator,
                      step)
        x = self.up(x, T)
        x = torch.where(make_non_pad_mask(lengths, T)[..., None], x, 0.0)
        smin = None
        if self.dynamics and training:
            smin = ScheduledFloat((0.0, 0.9), (20000.0, 0.2))(
                NO_STEP if step is None else float(step))
        if self.full_dim_bypass:
            return self.stack_bypass(
                convert_num_channels(x_orig, self.embed_dim), x,
                scale_min=smin)
        return self._common_bypass(x_orig, x, smin)

    def _common_bypass(self, x_orig: torch.Tensor, x: torch.Tensor,
                       scale_min: Optional[float] = None) -> torch.Tensor:
        d = min(x_orig.shape[-1], self.embed_dim)
        out = self.stack_bypass(x_orig[..., :d], x[..., :d],
                                scale_min=scale_min)
        if self.embed_dim > d:
            out = torch.cat([out, x[..., d:].to(out.dtype)], dim=-1)
        return out

    # ------------------------------------------------------------ streaming
    def init_cache(self, batch_size: int, chunk: int, left_chunks: int,
                   device: torch.device | str = "cpu"
                   ) -> List[Dict[str, torch.Tensor]]:
        """Each layer's caches for `chunk` base-rate frames per step and
        `left_chunks` chunks of left context at this stack's rate."""
        left = left_chunks * max(chunk // self.downsample_factor, 1)
        return [layer.init_cache(batch_size, left, device)
                for layer in self.layers]

    def streaming_step(self, x: torch.Tensor,
                       caches: List[Dict[str, torch.Tensor]],
                       valid_cache: int
                       ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """x (B, chunk, D_in) at the base rate; `valid_cache` the host
        count of cached frames at this stack's rate. `full_dim_bypass`
        raises: JAX's streaming step ignores it (reference caveat 1)."""
        if self.full_dim_bypass:
            raise NotImplementedError(
                "streaming with full_dim_bypass: JAX's streaming step "
                "ignores it, so there is no reference to hold it to")
        T = x.shape[1]
        h = self.downsample(convert_num_channels(x, self.embed_dim))
        C = h.shape[1]
        L = caches[0]["key"].shape[1] if caches else 0
        pos_table = self.penc.table(L + C - 1, h.device)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, nc = layer.streaming_step(h, pos_table, cache, valid_cache)
            new_caches.append(nc)
        return self._common_bypass(x, self.up(h, T)), new_caches


# ------------------------------------------------------------------ model
@dataclasses.dataclass
class Zipformer2Config:
    """The fields the serving and training forwards read. The chunk and
    left-context lists are read by the task's chunk sampling
    (tasks/rnnt.py:sample_chunk). `remat` / `remat_policy` turn on each
    layer's activation recompute in training (`recomputed`; a policy
    other than "full" or "dots" raises when `remat` is on, as JAX's
    `_remat_kwargs` does). `from_config` ignores the JAX config's layout
    switch scan_layers, which changes no value (convert.py reads either
    layout), and its kernel switches (use_flash_attn, flash_min_batch,
    score_dtype): the port computes the weights with its CUDA kernel on
    the card at every batch size, with f32 scores, as the JAX `fused`
    path does."""
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

    @property
    def output_dim(self) -> int:
        return max(self.encoder_dim)


class Zipformer2(nn.Module):
    def __init__(self, config: Zipformer2Config):
        super().__init__()
        cfg = self.config = config
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{cfg.remat_policy!r}")
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
                dropout=cfg.dropout,
                dynamics=cfg.dynamics,
                remat=cfg.remat_policy if cfg.remat else None)
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
                generator: Optional[torch.Generator] = None,
                step: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`training` turns on dropout and the feature mask, drawn from
        `generator` (on the input's device), and with `dynamics` the
        training dynamics at the global `step` (a host number); off, the
        forward is the serving forward."""
        x, lens = self.embed(feats, lengths)
        return self.encode_embedded(x, lens, chunk_size, left_context_chunks,
                                    training, generator, step)

    def encode_embedded(self, x: torch.Tensor, lens: torch.Tensor,
                        chunk_size: int = -1, left_context_chunks: int = -1,
                        training: bool = False,
                        generator: Optional[torch.Generator] = None,
                        step: Optional[float] = None
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
            x = stack(x, lens, attn_mask_fn, training, generator, step)
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

    # -------------------------------------------------------- true streaming
    PRIME_EXTRA_RAW = Conv2dSubsampling.RAW_TAIL

    def init_streaming_state(self, batch_size: int, chunk_size: int = 32,
                             left_context_chunks: int = 4,
                             device: torch.device | str = "cpu"
                             ) -> Dict[str, Any]:
        """Zero caches for a causal config: the frontend's, six per layer,
        and the host count of processed chunks. `chunk_size` is in
        post-frontend frames. The first chunk goes through
        `streaming_prime` with 2·chunk_size + PRIME_EXTRA_RAW raw fbank
        frames, every later one through `streaming_step` with
        2·chunk_size; the outputs then equal the chunk-masked forward's
        from frame 0."""
        cfg = self.config
        if not cfg.causal:
            raise ValueError("true streaming requires a causal config")
        if cfg.full_dim_bypass:
            raise NotImplementedError(
                "streaming with full_dim_bypass: JAX's streaming step "
                "ignores it, so there is no reference to hold it to")
        for f in (*cfg.downsampling_factor, cfg.output_downsampling_factor):
            if chunk_size % f:
                raise ValueError(f"chunk_size {chunk_size} is not divisible "
                                 f"by the downsampling factor {f}")
        if 2 * chunk_size < Conv2dSubsampling.RAW_TAIL:
            raise ValueError(f"chunk_size {chunk_size} is below "
                             f"{Conv2dSubsampling.RAW_TAIL // 2}: a step "
                             f"must cover the frontend's raw tail")
        dims = cfg.encoder_dim
        if dims[-1] != max(dims):
            raise ValueError("streaming requires the last stack to be the "
                             "widest")
        return {"embed": self.embed.init_cache(batch_size, device),
                "stacks": [stack.init_cache(batch_size, chunk_size,
                                            left_context_chunks, device)
                           for stack in self.stacks],
                "processed": 0, "chunk_size": int(chunk_size)}

    def _stream_tail(self, x: torch.Tensor, embed_cache: Dict[str, Any],
                     state: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The stacks and the output downsample on one chunk of sub-frames;
        the last stack is the widest, so it alone gives every channel."""
        chunk, processed = state["chunk_size"], state["processed"]
        caches = []
        for stack, cache in zip(self.stacks, state["stacks"]):
            valid = processed * max(chunk // stack.downsample_factor, 1)
            x, nc = stack.streaming_step(x, cache, valid)
            caches.append(nc)
        return self.out_downsample(x).float(), {
            "embed": embed_cache, "stacks": caches,
            "processed": processed + 1, "chunk_size": chunk}

    @staticmethod
    def _check_frames(feats: torch.Tensor, want: int, what: str) -> None:
        if feats.shape[1] != want:
            raise ValueError(f"{what} takes {want} raw frames, got "
                             f"{feats.shape[1]}")

    def streaming_prime(self, feats: torch.Tensor, state: Dict[str, Any]
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """First chunk: (B, 2·chunk + PRIME_EXTRA_RAW, F) raw fbank frames
        → (B, chunk // output_downsampling_factor, full_dim) f32 and the
        new state."""
        chunk = state["chunk_size"]
        self._check_frames(feats, 2 * chunk + self.PRIME_EXTRA_RAW,
                           "streaming_prime")
        x, embed_cache = self.embed.stream_prime(feats, state["embed"])
        return self._stream_tail(x, embed_cache, state)

    def streaming_step(self, feats: torch.Tensor, state: Dict[str, Any]
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Steady state: (B, 2·chunk, F) raw fbank frames → (B, chunk //
        output_downsampling_factor, full_dim) f32 and the new state."""
        self._check_frames(feats, 2 * state["chunk_size"], "streaming_step")
        x, embed_cache = self.embed.stream_step(feats, state["embed"])
        return self._stream_tail(x, embed_cache, state)
