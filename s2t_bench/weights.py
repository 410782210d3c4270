"""Weights from a seed, made on the device in one call: every parameter
of two or more dimensions is drawn from a normal of standard deviation
1/sqrt(fan-in) (fan-in = the product of its dimensions after the first,
in torch's (out, in, ...) layout), in the order of its name; the others
(biases, norm scales, bypass scales) keep the constants that the model
is built with. The program and the reference get the same weights."""

from __future__ import annotations

import math

import torch
from torch import nn

from .workload import derived_seed

WEIGHT_STREAM = 5


def write_weights(model: nn.Module, seed: int) -> int:
    """Overwrite `model`'s matrices and kernels; returns how many leaves."""
    params = dict(model.named_parameters())
    names = sorted(n for n, p in params.items() if p.dim() >= 2)
    if not names:
        return 0
    device = params[names[0]].device
    sizes = [params[n].numel() for n in names]
    gen = torch.Generator(device).manual_seed(
        derived_seed(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    with torch.no_grad():
        for n, chunk in zip(names, flat.split(sizes)):
            p = params[n]
            fan_in = math.prod(p.shape[1:])
            p.copy_(chunk.view(p.shape) / math.sqrt(fan_in))
    return len(names)
