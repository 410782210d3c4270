"""Flax-like building blocks: f32 parameters, compute in the layer's dtype.

`Dense`, `Conv` and `Embed` follow flax.linen's `param_dtype=f32,
dtype=...` behaviour: parameters are stored in f32, and the inputs and
parameters are cast to `dtype` for the computation. Each layer can
initialise itself from a `torch.Generator` the way the JAX package's
initialisers do (`init_parameters`):

- Dense/Conv kernels: variance_scaling(scale, "fan_in", "truncated_normal")
  (lecun_normal for scale 1; `scaled_init(s)` is scale s²), biases zero;
- Embed: variance_scaling(1, "fan_in", "normal", out_axis=0), i.e.
  N(0, 1/features).

Parameter layouts are PyTorch's (Linear (out, in), Conv (out, in/g, *k));
speech2text_torch/convert.py maps the flax layouts onto them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def dtype_of(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator,
                      truncated: bool = True) -> None:
    with torch.no_grad():
        if truncated:
            std = math.sqrt(scale / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        else:
            t.normal_(0.0, math.sqrt(scale / fan_in), generator=generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax.linen.Dropout: keep with probability 1 − rate and scale by
    1/(1 − rate); the identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype
        self.init_scale = init_scale

    def init_parameters(self, g: torch.Generator) -> None:
        variance_scaling_(self.weight, self.init_scale,
                          self.weight.shape[1], g)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """VALID convolution over channels-last input: (B, *spatial, C) for
    1-D or 2-D kernels, as flax.linen.Conv lays it out."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = None,
                 groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides or (1,) * len(self.kernel_size))
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(
            out_features, in_features // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def init_parameters(self, g: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * math.prod(self.kernel_size)
        variance_scaling_(self.weight, 1.0, fan_in, g)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        nd = len(self.kernel_size)
        b = None if self.bias is None else self.bias.to(dt)
        h = x.to(dt).movedim(-1, 1)                  # channels first
        conv = F.conv1d if nd == 1 else F.conv2d
        h = conv(h, self.weight.to(dt), b, stride=self.strides,
                 groups=self.groups)
        return h.movedim(1, -1)


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features))
        self.dtype = dtype

    def init_parameters(self, g: torch.Generator) -> None:
        variance_scaling_(self.weight, 1.0, self.weight.shape[1], g,
                          truncated=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.weight.to(self.dtype))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every layer of `module` in a fixed order (module
    registration order), so one seed gives one set of weights."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_parameters"):
            m.init_parameters(generator)
