"""What decides `correct`: the first steps of the program held to the
plain reference (s2t_bench/reference/) on the same weights and batches.

A run's set-up takes CHECKED_STEPS steps of the program through the
window's own call and feed, on rows that all differ, and reads (a) each
step's loss, (b) every leaf's gradient norm after the first step, as the
optimizer got it (`p.grad`, left in place by the step, after any
global-norm clip), and (c) every leaf's change over the checked steps,
before the next step moves it. Once the window has closed and the
program is freed, the reference, built from the same config, weights
and seed, takes the same steps on the same batches, and the two are
compared by three numbers:

- loss_gap: the largest |program − reference| / |reference| of the
  steps' losses;
- grad_gap: over leaves, the largest |‖g_program‖ − ‖g_reference‖|
  divided by the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- change_gap: the same of the parameters' change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (the
  others move under Adam by round-off alone).

Each number has its limit in `checks/<cell>.json`. A number that is not
finite fails. `lower_precision` computes the reference in the precision
below the configuration's (the control): bf16 products in fp8 (e4m3,
a per-tensor scale), f32 products in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from .cell import Missing, shown

CHECKS_DIR = Path(__file__).resolve().parent / "checks"
CHECKED_STEPS = 3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVED_SHARE = 1e-3


@dataclasses.dataclass
class Readings:
    names: List[str]
    losses: List[float]
    grad: np.ndarray        # per leaf, after the first step
    change: np.ndarray      # per leaf, over the checked steps


def _leaf_norms(tensors: List[torch.Tensor]) -> np.ndarray:
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).cpu().double().numpy()


def checked_steps(model: nn.Module,
                  step: Callable[[Dict[str, torch.Tensor], int],
                                 Dict[str, torch.Tensor]],
                  batch_of: Callable[[int], Dict[str, torch.Tensor]],
                  loss_key: str) -> Readings:
    """Steps 0 .. CHECKED_STEPS−1 of `step` on `batch_of(i)`, read."""
    params = dict(model.named_parameters())
    names = sorted(params)
    start = [params[n].detach().clone() for n in names]
    losses, grad = [], None
    for i in range(CHECKED_STEPS):
        out = step(batch_of(i), i)
        losses.append(out[loss_key].detach().float())
        if i == 0:
            grad = _leaf_norms([
                params[n].grad if params[n].grad is not None
                else torch.zeros_like(params[n]) for n in names])
    change = _leaf_norms([params[n].detach().float() - s.float()
                          for n, s in zip(names, start)])
    return Readings(names, [float(x) for x in losses], grad, change)


def compare(program: Readings, reference: Readings) -> Dict[str, float]:
    """The three numbers of `program` against `reference`."""
    if program.names != reference.names:
        raise ValueError("the program and the reference have other leaves")
    lp, lr = np.array(program.losses), np.array(reference.losses)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    gr, gp = reference.grad, program.grad
    g_med = float(np.median(gr))
    grad_gap = float(np.max(np.abs(gp - gr) / np.maximum(gr, g_med)))
    moved = gr >= MOVED_SHARE * g_med
    dr, dp = reference.change[moved], program.change[moved]
    d_med = float(np.median(dr))
    change_gap = float(np.max(np.abs(dp - dr) / np.maximum(dr, d_med)))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def limits_of(cell: str) -> Dict[str, float]:
    """The limits of `cell`'s numbers: checks/<cell>.json, or Missing."""
    path = CHECKS_DIR / f"{cell}.json"
    if not path.is_file():
        raise Missing(f"{cell}: no check limits {shown(path)}")
    with open(path) as f:
        spec = json.load(f)
    return {k: float(spec["limits"][k]) for k in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS)


# ------------------------------------------------------------- the control
def _rounded(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The value `q` forward, the gradient of `x` backward (the product
    that takes it then saves and uses the rounded operand)."""
    return x + (q - x).detach()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, back in its dtype."""
    with torch.no_grad():
        amax = x.abs().amax().float().clamp(min=1e-12)
        scale = amax / 448.0
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float()
             * scale).to(x.dtype)
    return _rounded(x, q)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    with torch.no_grad():
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        q = bits.view(torch.float32).to(x.dtype)
    return _rounded(x, q)


@contextlib.contextmanager
def lower_precision(device: torch.device):
    """The reference's products one precision lower than its config
    states: Dense and Conv operands of bf16 layers through fp8, of f32
    layers through TF32 (on a card by TF32 itself, on the CPU by rounding
    the operands)."""
    from .reference.models import layers
    F = torch.nn.functional
    old = layers.Dense.forward, layers.Conv.forward
    cuda = device.type == "cuda"
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    def low(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if dtype == torch.bfloat16:
            return _fp8(t)
        return t if cuda else _tf32(t)

    def dense(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(low(x.to(dt), dt), low(self.weight.to(dt), dt), b)

    def conv(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        h = low(x.to(dt), dt).movedim(-1, 1)
        fn = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        h = fn(h, low(self.weight.to(dt), dt), b, stride=self.strides,
               groups=self.groups)
        return h.movedim(1, -1)

    layers.Dense.forward, layers.Conv.forward = dense, conv
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        layers.Dense.forward, layers.Conv.forward = old
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
