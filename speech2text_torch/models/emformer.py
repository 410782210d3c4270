"""Emformer-style streaming transformer encoder (port of
speech2text_tpu/models/emformer.py).

Conv subsampling (models/conformer.py's `ConvSubsampling`) → `num_layers`
Emformer layers → an output Dense, zeroed at padded frames and returned
in f32 with the output lengths. Training runs the full utterance under a
segment-structured mask: a frame attends to its own segment ± the left
and right context and, with `max_memory_size` > 0, to the masked mean of
each of up to `max_memory_size` preceding segments (the memory bank,
built per layer from that layer's input). `init_state` /
`streaming_step` run it chunk by chunk: per layer the last
`left_context_length` activations and a rolling bank, with a step
counter that masks the slots not yet filled, so a fresh stream sees what
the training mask allows. `streaming_forward` is the full forward.

As in the JAX package: one shared `qkv` Dense with the same `ln_attn`
for queries and keys, scores and softmax in f32 with masked keys at
−1e30 (a query whose whole window is padding comes out uniform, never
NaN), then `attn_out`, and `ln_ffn` → the Conformer's FeedForward
(swish; dropout after it in training, from an explicit generator).
LayerNorm ε is flax's 1e-6. Submodules keep the flax names (`subsample`,
`layer{i}` as `layers.{i}`, `qkv`, `attn_out`, `ln_attn`, `ln_ffn`,
`ffn`, `out`), which speech2text_torch/convert.py maps one to one.
Attention is plain torch: the JAX package computes it outside Pallas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.masking import make_non_pad_mask
from .conformer import ConvSubsampling, FeedForward
from .layers import Dense, LayerNorm, dtype_of


@dataclasses.dataclass
class EmformerConfig:
    feats_dim: int = 80
    subsampling_rate: int = 4
    input_dim: int = 256
    num_heads: int = 8
    ffn_dim: int = 1024
    num_layers: int = 12
    segment_length: int = 16        # frames at the subsampled rate
    left_context_length: int = 32
    right_context_length: int = 4
    max_memory_size: int = 0        # past-segment summaries in K/V (0 = off)
    output_dim: int = 256
    dropout: float = 0.1
    dtype: str = "float32"


def emformer_attention_mask(T: int, segment: int, left: int, right: int,
                            device=None) -> torch.Tensor:
    """(T, T) bool: query i may attend key j iff j lies within
    [seg_start(i) − left, seg_end(i) + right]."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    seg_start = torch.div(i, segment, rounding_mode="floor") * segment
    seg_end = seg_start + segment - 1
    return (j >= seg_start - left) & (j <= seg_end + right)


def emformer_memory_mask(T: int, segment: int, max_memory: int,
                         device=None) -> torch.Tensor:
    """(T, S) bool over segment-summary slots: query i sees the summary of
    segment s iff seg(i) − max_memory ≤ s ≤ seg(i) − 1."""
    S = -(-T // segment)
    seg = torch.div(torch.arange(T, device=device)[:, None], segment,
                    rounding_mode="floor")
    s = torch.arange(S, device=device)[None, :]
    return (s >= seg - max_memory) & (s <= seg - 1)


def segment_summaries(h: torch.Tensor, pad_mask: torch.Tensor,
                      segment: int) -> torch.Tensor:
    """(B, T, D) → (B, S, D) masked mean over each segment's valid
    frames."""
    B, T, D = h.shape
    S = -(-T // segment)
    pad_t = S * segment - T
    hp = nn.functional.pad(h, (0, 0, 0, pad_t))
    mp = nn.functional.pad(pad_mask.to(h.dtype), (0, pad_t))
    hp = hp.reshape(B, S, segment, D) * mp.reshape(B, S, segment, 1)
    n = torch.clamp(mp.reshape(B, S, segment).sum(-1, keepdim=True),
                    min=1.0)
    return hp.sum(dim=2) / n


class EmformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.ln_attn = LayerNorm(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.attn_out = Dense(dim, dim, dtype=dtype)
        self.ln_ffn = LayerNorm(dim, dtype=dtype)
        self.ffn = FeedForward(dim, ffn_dim, dropout, dtype)

    def _attend(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                mask: torch.Tensor, training: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """`x_q` is the last Tq rows of `x_kv` (every caller's layout), so
        one `qkv` product serves the queries, keys and values."""
        B, Tq, D = x_q.shape
        Tk = x_kv.shape[1]
        H = self.num_heads
        hd = D // H
        qkv = self.qkv(self.ln_attn(x_kv))
        q = qkv[:, Tk - Tq:, :D].reshape(B, Tq, H, hd).transpose(1, 2)
        k = qkv[..., D:2 * D].reshape(B, Tk, H, hd).transpose(1, 2)
        v = qkv[..., 2 * D:].reshape(B, Tk, H, hd).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        scores = torch.where(mask, scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(B, Tq, D).to(self.dtype)
        x = x_q + self.attn_out(out)
        return x + self.ffn(self.ln_ffn(x), training, generator)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                pad_mask: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                memory: Optional[torch.Tensor] = None,
                mem_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mask = attn_mask[None, None] & pad_mask[:, None, None, :]
        if memory is None:
            return self._attend(x, x, mask, training, generator)
        kv = torch.cat([memory, x], dim=1)
        full = torch.cat([mem_mask[None, None].expand(
            (x.shape[0], 1) + tuple(mem_mask.shape)), mask], dim=-1)
        return self._attend(x, kv, full, training, generator)

    def step(self, x_chunk: torch.Tensor, cache: torch.Tensor,
             cache_mask: torch.Tensor, bank: Optional[torch.Tensor] = None,
             bank_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x_chunk (B, C, D) the current chunk; cache (B, L, D) the
        previous activations of this layer's input; optionally the rolling
        memory bank (B, M, D). The masks (B, L) and (B, M) flag the slots
        filled so far. Returns (out, new cache)."""
        B, C, _ = x_chunk.shape
        L = cache.shape[1]
        parts = [cache, x_chunk]
        mparts = [cache_mask[:, None, None, :].expand(B, 1, C, L),
                  torch.ones((B, 1, C, C), dtype=torch.bool,
                             device=x_chunk.device)]
        if bank is not None:
            parts.insert(0, bank)
            mparts.insert(0, bank_mask[:, None, None, :].expand(
                B, 1, C, bank.shape[1]))
        out = self._attend(x_chunk, torch.cat(parts, dim=1),
                           torch.cat(mparts, dim=-1), False, None)
        return out, torch.cat([cache, x_chunk], dim=1)[:, -L:]


class Emformer(nn.Module):
    def __init__(self, config: EmformerConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = dt = dtype_of(cfg.dtype)
        self.subsample = ConvSubsampling(cfg.subsampling_rate,
                                         cfg.feats_dim, cfg.input_dim, dt)
        self.layers = nn.ModuleList(
            EmformerLayer(cfg.input_dim, cfg.num_heads, cfg.ffn_dim,
                          cfg.dropout, dt) for _ in range(cfg.num_layers))
        self.out = Dense(cfg.input_dim, cfg.output_dim, dtype=dt)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (B, T, feats_dim), lengths (B,) → (out (B, T',
        output_dim) f32, zero past each length; out_lens (B,) int32)."""
        cfg = self.config
        h, out_lens = self.subsample(feats, lengths)
        T, dev = h.shape[1], h.device
        amask = emformer_attention_mask(T, cfg.segment_length,
                                        cfg.left_context_length,
                                        cfg.right_context_length, dev)
        pad_mask = make_non_pad_mask(out_lens, T)
        mmask = (emformer_memory_mask(T, cfg.segment_length,
                                      cfg.max_memory_size, dev)
                 if cfg.max_memory_size > 0 else None)
        for layer in self.layers:
            mem = None if mmask is None else segment_summaries(
                h, pad_mask, cfg.segment_length)
            h = layer(h, amask, pad_mask, training, generator, memory=mem,
                      mem_mask=mmask)
        out = torch.where(pad_mask[..., None], self.out(h), 0.0)
        return out.float(), out_lens

    streaming_forward = forward

    # ------------------------------------------------------------ streaming
    def init_state(self, batch_size: int,
                   device=None) -> List[torch.Tensor]:
        """Flat state list: num_layers activation caches, then (with
        max_memory_size > 0) num_layers memory banks, then the step
        counter (B,) int32 that masks the slots not yet filled."""
        cfg = self.config
        shape = (batch_size, cfg.left_context_length, cfg.input_dim)
        state = [torch.zeros(shape, dtype=self.dtype, device=device)
                 for _ in range(cfg.num_layers)]
        if cfg.max_memory_size > 0:
            state += [torch.zeros((batch_size, cfg.max_memory_size,
                                   cfg.input_dim), dtype=self.dtype,
                                  device=device)
                      for _ in range(cfg.num_layers)]
        state.append(torch.zeros((batch_size,), dtype=torch.int32,
                                 device=device))
        return state

    def streaming_step(self, chunk_feats: torch.Tensor,
                       states: List[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """chunk_feats (B, T_chunk, F), the raw features of one segment
        (+ lookahead) → (out (B, C, output_dim) f32, new states). With the
        bank on, a chunk must give exactly `segment_length` frames after
        subsampling (the bank holds one summary per segment); anything
        else raises ValueError."""
        cfg = self.config
        use_mem = cfg.max_memory_size > 0
        n = cfg.num_layers
        count = states[-1]
        B, Tc = chunk_feats.shape[:2]
        h, _ = self.subsample(chunk_feats, torch.full(
            (B,), Tc, dtype=torch.int32, device=chunk_feats.device))
        C = h.shape[1]
        if use_mem and C != cfg.segment_length:
            raise ValueError(
                f"streaming_step chunk is {C} post-subsample frames but "
                f"max_memory_size>0 requires exactly segment_length="
                f"{cfg.segment_length} frames per step")
        L = cfg.left_context_length
        dev = h.device
        n_cached = torch.clamp(count * C, max=L)
        cache_mask = torch.arange(L, device=dev)[None, :] >= \
            (L - n_cached)[:, None]
        bank_mask, ones = None, torch.ones((B, C), dtype=torch.bool,
                                           device=dev)
        if use_mem:
            M = cfg.max_memory_size
            n_bank = torch.clamp(count, max=M)
            bank_mask = torch.arange(M, device=dev)[None, :] >= \
                (M - n_bank)[:, None]
        new_states = list(states)
        for i, layer in enumerate(self.layers):
            out, new_states[i] = layer.step(
                h, states[i], cache_mask,
                bank=states[n + i] if use_mem else None, bank_mask=bank_mask)
            if use_mem:
                summary = segment_summaries(h, ones, C)
                new_states[n + i] = torch.cat([states[n + i], summary],
                                              dim=1)[:, -cfg.max_memory_size:]
            h = out
        new_states[-1] = count + 1
        return self.out(h).float(), new_states
