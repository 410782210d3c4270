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

`pos_enc` chooses the attention's positional term. "none" (the default,
the JAX package's) has none. "rel" is Transformer-XL's relative
attention as the Conformer paper (Gulati et al. 2020) uses it, which the
JAX package does not have: R is the (2T−1, D) sinusoidal table of the
offsets i − j from T − 1 down to −(T − 1) (sin at even, cos at odd
features, as ESPnet lays it out), P = R·W_pos a Dense with no bias
(`Dense_2`) split into heads, u and v learned (H, d_k) biases
(`pos_bias_u`, `pos_bias_v`), and

    score(i, j) = [(q_i + u)·k_j + (q_i + v)·P_{i−j}] / √d_k,

with no scaling of the input by √D. Its (B, H, T, T) scores, softmax
and dropout mask are not kept for the backward: the backward computes
them again from q, k, v and P, with the dropout generator's state of
the forward (`_RelAttention`), so a layer keeps O(B·T·D) for its
attention where the plain graph keeps three (B, H, T, T) tensors.
Each block's attention is the span "mhsa" (utils/tracing.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masking import make_non_pad_mask
from ..utils.tracing import span
from .layers import Conv, Dense, LayerNorm, dropout, dtype_of

POS_ENCODINGS = ("none", "rel")


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
    pos_enc: str = "none"         # none | rel


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


def rel_position_table(T: int, dim: int, device: torch.device
                       ) -> torch.Tensor:
    """R (2T − 1, dim) f32: row r is the offset T − 1 − r, sin(p·ω_m) at
    feature 2m and cos(p·ω_m) at 2m + 1, ω_m = 10000^(−2m/dim)."""
    pos = torch.arange(T - 1, -T, -1, device=device, dtype=torch.float32)
    omega = torch.exp(torch.arange(0, dim, 2, device=device,
                                   dtype=torch.float32)
                      * (-math.log(10000.0) / dim))
    angle = pos[:, None] * omega[None, :]
    return torch.stack((torch.sin(angle), torch.cos(angle)),
                       dim=-1).reshape(2 * T - 1, dim)


def rel_scores(q: torch.Tensor, k: torch.Tensor, u: torch.Tensor,
               vb: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The scores (B, H, T, T) f32, before the mask, of q, k (B, H, T, d),
    biases u, vb (H, d) and P (H, 2T − 1, d); products in f32. (q + v)·P
    over every offset is (B, H, T, 2T − 1); score (i, j) reads its column
    T − 1 − i + j, a strided view with no copy."""
    B, H, T, d = q.shape
    qf = q.float()
    ac = torch.matmul(qf + u[:, None, :], k.float().transpose(-1, -2))
    bd = torch.matmul(qf + vb[:, None, :], p.transpose(-1, -2))
    W = bd.shape[-1]
    bd = bd.as_strided((B, H, T, T), (H * T * W, T * W, W - 1, 1),
                       bd.storage_offset() + T - 1)
    return (ac + bd) / math.sqrt(d)


def _rel_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                u: torch.Tensor, vb: torch.Tensor, p: torch.Tensor,
                key_mask: torch.Tensor, rate: float,
                generator: Optional[torch.Generator], dtype: torch.dtype
                ) -> torch.Tensor:
    """`rel_scores` with padded keys at −1e30 → softmax → dropout →
    the heads' outputs (B, H, T, d) f32."""
    scores = rel_scores(q, k, u, vb, p)
    scores = torch.where(key_mask[:, None, None, :], scores, -1e30)
    attn = torch.softmax(scores, dim=-1).to(dtype)
    attn = dropout(attn, rate, rate > 0.0, generator)
    return torch.matmul(attn.float(), v.float())


class _RelAttention(torch.autograd.Function):
    """`_rel_attend` whose backward computes the forward again (with the
    dropout generator set back to its state at the forward, so the same
    mask) and differentiates that: only the inputs are kept."""

    @staticmethod
    def forward(ctx, q, k, v, u, vb, p, key_mask, rate, generator, dtype):
        ctx.rate, ctx.dtype = rate, dtype
        ctx.gen_device = generator.device
        ctx.gen_state = generator.get_state()
        ctx.save_for_backward(q, k, v, u, vb, p, key_mask)
        return _rel_attend(q, k, v, u, vb, p, key_mask, rate, generator,
                           dtype)

    @staticmethod
    def backward(ctx, grad):
        *inputs, key_mask = ctx.saved_tensors
        generator = torch.Generator(ctx.gen_device)
        generator.set_state(ctx.gen_state)
        want = [i for i, n in enumerate(ctx.needs_input_grad[:6]) if n]
        inputs = [t.detach().requires_grad_(i in want)
                  for i, t in enumerate(inputs)]
        with torch.enable_grad():
            out = _rel_attend(*inputs, key_mask, ctx.rate, generator,
                              ctx.dtype)
        got = torch.autograd.grad(out, [inputs[i] for i in want], grad)
        grads = [None] * 6
        for i, g in zip(want, got):
            grads[i] = g
        return (*grads, None, None, None, None)


def _default_generator(device: torch.device) -> torch.Generator:
    """The generator that torch.rand(generator=None) draws from."""
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


class MaskedMHSA(nn.Module):
    """Multi-head self-attention with padded keys masked: without
    positional terms (`pos_enc` "none"), or with Transformer-XL's
    relative ones ("rel": `Dense_2`, `pos_bias_u`, `pos_bias_v`)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, pos_enc: str = "none"):
        super().__init__()
        if pos_enc not in POS_ENCODINGS:
            raise ValueError(f"pos_enc {pos_enc!r} (one of {POS_ENCODINGS})")
        self.num_heads = num_heads
        self.dtype = dtype
        self.pos_enc = pos_enc
        self.Dense_0 = Dense(dim, 3 * dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)
        if pos_enc == "rel":
            if dim % 2 or dim % num_heads:
                raise ValueError(f"relative attention needs an even width "
                                 f"that the {num_heads} heads divide, not "
                                 f"{dim}")
            hd = dim // num_heads
            self.Dense_2 = Dense(dim, dim, bias=False, dtype=dtype)
            self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, hd))
            self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, hd))

    def init_parameters(self, g: torch.Generator) -> None:
        """u and v xavier-uniform (draws nothing without them)."""
        if self.pos_enc != "rel":
            return
        H, hd = self.pos_bias_u.shape
        limit = math.sqrt(6.0 / (H + hd))
        with torch.no_grad():
            for b in (self.pos_bias_u, self.pos_bias_v):
                b.uniform_(-limit, limit, generator=g)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                rate: float = 0.0, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
                   for t in self.Dense_0(x).chunk(3, dim=-1))
        if self.pos_enc == "rel":
            out = self._relative(q, k, v, pad_mask,
                                 rate if training else 0.0, generator)
        else:
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
            scores = scores / math.sqrt(hd)
            scores = torch.where(pad_mask[:, None, None, :], scores, -1e30)
            attn = torch.softmax(scores, dim=-1).to(self.dtype)
            attn = dropout(attn, rate, training, generator)
            out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(B, T, D).to(self.dtype)
        return self.Dense_1(out)

    def _relative(self, q, k, v, pad_mask, rate, generator):
        H, hd = self.pos_bias_u.shape
        T = q.shape[2]
        table = rel_position_table(T, H * hd, q.device)
        p = self.Dense_2(table).float().reshape(2 * T - 1, H, hd) \
            .transpose(0, 1)
        args = (q, k, v, self.pos_bias_u, self.pos_bias_v, p)
        if not torch.is_grad_enabled() or \
                not any(t.requires_grad for t in args):
            return _rel_attend(*args, pad_mask, rate, generator, self.dtype)
        if generator is None:
            generator = _default_generator(q.device)
        return _RelAttention.apply(*args, pad_mask, rate, generator,
                                   self.dtype)


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
                 dtype: torch.dtype = torch.float32, pos_enc: str = "none"):
        super().__init__()
        self.rate = rate
        self.FeedForward_0 = FeedForward(dim, ffn_dim, rate, dtype)
        self.MaskedMHSA_0 = MaskedMHSA(dim, num_heads, dtype, pos_enc)
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
        h = self.LayerNorm_1(x)
        with span("mhsa"):
            h = self.MaskedMHSA_0(h, pad_mask, self.rate, training, generator)
        x = x + h
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
                cfg.depthwise_conv_kernel_size, cfg.dropout, dt,
                cfg.pos_enc))
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
